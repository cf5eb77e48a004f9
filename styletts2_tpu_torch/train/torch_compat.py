"""Reference torch checkpoint interop (the port of
``styletts2_tpu/train/torch_compat.py``).

Every net of the port names its parameters after the reference torch
``state_dict`` keys, as the JAX package's trees do, so a reference state
dict maps onto a net by key.  Conversions produce nested dicts of numpy
arrays, the JAX package's form, so one converted tree loads into either
package (``models.zoo.load_jax_params`` here).

Also implements the reference's shape-adaptation rules for mismatched
checkpoints (ref: models.py:1113-1215): strip ``module.`` prefixes, keep
current weights for missing keys, copy+pad grown embedding/positional tables.
"""

from __future__ import annotations

import logging
import pickle
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..models.zoo import flatten, nest

logger = logging.getLogger(__name__)


def to_numpy_state(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Tensors (or arrays) -> numpy copies that no later in-place update of
    the source can change."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy().copy()
        else:
            out[k] = np.asarray(v)
    return out


def strip_prefix(state: Mapping[str, Any], prefix: str = "module.") -> Dict[str, Any]:
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in state.items()}


def match_state_dict(
    current_flat: Mapping[str, np.ndarray],
    loaded_flat: Mapping[str, np.ndarray],
    module_name: str = "",
    verbose: bool = True,
) -> Dict[str, np.ndarray]:
    """Align a checkpoint with the current parameter shapes
    (ref: models.py:1113-1215): missing keys keep current values; tables
    whose trailing dims match are copied row-wise and padded with the last
    checkpoint row (a grown vocabulary); incompatible shapes keep current
    values."""
    loaded = strip_prefix(dict(loaded_flat))
    aligned: Dict[str, np.ndarray] = {}
    for name, cur in current_flat.items():
        cur = np.asarray(cur)
        if name not in loaded:
            if verbose:
                logger.info("[%s] missing key kept at current init: %s", module_name, name)
            aligned[name] = cur
            continue
        new = np.asarray(loaded[name])
        if new.shape == cur.shape:
            aligned[name] = new.astype(cur.dtype)
        elif new.shape[1:] == cur.shape[1:] and new.ndim == cur.ndim and cur.ndim >= 1:
            resized = cur.copy()
            n = min(cur.shape[0], new.shape[0])
            resized[:n] = new[:n].astype(cur.dtype)
            if cur.shape[0] > n and new.shape[0] > 0:
                resized[n:] = new[-1:].astype(cur.dtype)
            aligned[name] = resized
            if verbose:
                logger.info("[%s] resized %s: %s -> %s", module_name, name, new.shape,
                            cur.shape)
        else:
            if verbose:
                logger.info("[%s] incompatible %s: ckpt %s vs %s; kept current",
                            module_name, name, new.shape, cur.shape)
            aligned[name] = cur
    return aligned


def load_torch_file(path: str) -> Dict[str, Any]:
    """A ``.pth``/``.t7`` file on the CPU, read with ``weights_only=True``;
    a file that holds other objects than tensors and containers (a pickled
    optimizer or scheduler) is read in full, with a log line."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        logger.warning("%s holds objects beyond tensors; reading it in full (%s)", path,
                       str(exc).splitlines()[0])
        return torch.load(path, map_location="cpu", weights_only=False)


def convert_module_state(
    state: Mapping[str, Any],
    current_params: Optional[Mapping] = None,
    module_name: str = "",
) -> Dict:
    """Torch flat state dict -> nested numpy params, shape-adapted against
    ``current_params`` (nested) when given."""
    flat = to_numpy_state(strip_prefix(dict(state)))
    if current_params is not None:
        cur_flat = {k: np.asarray(v) for k, v in flatten(current_params).items()}
        flat = match_state_dict(cur_flat, flat, module_name)
    return nest(flat)
