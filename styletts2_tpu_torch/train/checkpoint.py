"""Checkpoint save/load/convert (the port of
``styletts2_tpu/train/checkpoint.py``).

Native format: the JAX package's.  An ``.npz`` archive of ``net.<net>.<key>``
arrays (each net's ``state_dict``, whose keys are the JAX trees' flattened
keys) beside a ``<path>.meta.json`` of ``{epoch, iters, extra}``, so the
nets of a checkpoint cross between the packages in both directions.  The
port's AdamW states (``step``, ``exp_avg``, ``exp_avg_sq`` per parameter)
are stored as ``adamw.<net>.<parameter>.<name>``: not under ``opt.``, which
the JAX loader counts against an optax template, so a JAX resume of a port
file reads the nets and starts fresh moments.  The JAX package's ``opt.*``
leaves are not read here either: a resume from a JAX file starts fresh
AdamW states, with a log line.

Reference ``.pth`` conversion: maps each module state dict into nested
numpy params with shape adaptation (ref: models.py:1113-1239), including
the diffusion wrapper's duplicated ``unet.* / diffusion.net.*`` keys.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.zoo import export_params, flatten, load_jax_params, nest
from .optimizers import MultiOptimizer
from .torch_compat import (convert_module_state, load_torch_file, match_state_dict,
                           strip_prefix, to_numpy_state)

logger = logging.getLogger(__name__)

META_SUFFIX = ".meta.json"
ADAMW_PREFIX = "adamw."
ADAMW_STATE = ("step", "exp_avg", "exp_avg_sq")


def _npz_path(path: str) -> str:
    # np.savez appends ".npz" to other names: the meta file sits beside the real name
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, nets: nn.ModuleDict, optimizer: Optional[MultiOptimizer] = None,
                    epoch: int = 0, iters: int = 0, extra: Optional[Dict] = None) -> str:
    """Write ``nets`` (and ``optimizer``'s AdamW states) to ``path``; returns
    the ``.npz`` path written."""
    path = _npz_path(path)
    flat = {f"net.{name}.{k}": v.detach().cpu().numpy()
            for name, net in nets.items() for k, v in net.state_dict().items()}
    if optimizer is not None:
        for name, opt in optimizer.opts.items():
            for pname, p in optimizer.nets[name].named_parameters():
                for key, value in opt.state.get(p, {}).items():
                    flat[f"{ADAMW_PREFIX}{name}.{pname}.{key}"] = value.detach().cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    with open(path + META_SUFFIX, "w") as f:
        json.dump({"epoch": epoch, "iters": iters, "extra": extra or {}}, f)
    return path


def load_checkpoint(path: str, nets: Optional[nn.ModuleDict] = None,
                    optimizer: Optional[MultiOptimizer] = None
                    ) -> Tuple[Dict, int, int, Dict]:
    """Returns ``(params, epoch, iters, extra)``: ``params`` the file's nets
    as nested numpy trees, ``extra`` the free-form meta dict.  With ``nets``
    each net the file holds is loaded into the net of that name
    (``strict=True``); with ``optimizer`` its AdamW states are replaced by
    the file's (parameters the file has no state for start fresh)."""
    path = _npz_path(path)
    meta = {"epoch": 0, "iters": 0, "extra": {}}
    if os.path.exists(path + META_SUFFIX):
        with open(path + META_SUFFIX) as f:
            meta.update(json.load(f))
    with np.load(path) as data:
        files = set(data.files)
        params = nest({k[len("net."):]: data[k] for k in files if k.startswith("net.")})
        if nets is not None:
            for name in nets:
                if name not in params:
                    logger.warning("%s holds no %s: it keeps its current weights", path, name)
            load_jax_params({n: nets[n] for n in nets if n in params}, params)
        if optimizer is not None:
            if any(k.startswith("opt.") for k in files):
                logger.warning("%s holds the JAX package's optax states (opt.*), which the "
                               "port does not read: AdamW starts fresh", path)
            for name, opt in optimizer.opts.items():
                state = {}
                for i, (pname, _) in enumerate(optimizer.nets[name].named_parameters()):
                    keys = [f"{ADAMW_PREFIX}{name}.{pname}.{key}" for key in ADAMW_STATE]
                    if all(k in files for k in keys):
                        state[i] = {key: torch.from_numpy(data[k])
                                    for key, k in zip(ADAMW_STATE, keys)}
                opt.load_state_dict({"state": state,
                                     "param_groups": opt.state_dict()["param_groups"]})
    return params, int(meta["epoch"]), int(meta["iters"]), meta.get("extra", {})


# ---------------------------------------------------------------------------
# Reference .pth conversion
# ---------------------------------------------------------------------------

def _convert_diffusion(state: Mapping[str, Any]) -> Dict:
    """The torch diffusion wrapper stores the denoiser twice (``unet.*`` and
    ``diffusion.net.*``, ref: models.py:1080-1089); keep one copy."""
    out = {}
    for k, v in state.items():
        if k.startswith("unet."):
            out[k[len("unet."):]] = v
        elif k.startswith("diffusion.net."):
            out.setdefault(k[len("diffusion.net."):], v)
    return {"transformer": nest(to_numpy_state(out))}


def convert_reference_checkpoint(
    path: str,
    current_zoo: Optional[Mapping] = None,
    ignore_modules: Sequence[str] = (),
) -> Dict:
    """Convert a reference ``.pth`` training checkpoint ({net: {module:
    state_dict}}) into nested numpy params per net (ref:
    models.py:1218-1239), shape-adapted against ``current_zoo``'s nets."""
    state = load_torch_file(path)
    nets = state.get("net", state)
    zoo: Dict = {}
    for name, module_state in nets.items():
        if name in ignore_modules:
            continue
        module_state = strip_prefix(dict(module_state))
        if name == "diffusion":
            zoo[name] = _convert_diffusion(module_state)
        else:
            cur = current_zoo.get(name) if current_zoo else None
            zoo[name] = convert_module_state(module_state, cur, name)
    return zoo


def convert_plbert_checkpoint(ckpt_path: str) -> Dict:
    """PL-BERT ``step_*.t7`` -> bert params (ref: Utils/PLBERT/util.py:98-112)."""
    state = load_torch_file(ckpt_path)["net"]
    out = {}
    for k, v in state.items():
        k = k[7:] if k.startswith("module.") else k         # strip "module."
        if k.startswith("encoder."):
            k = k[8:]
            if k == "embeddings.position_ids":
                continue
            out[k] = v
    return nest(to_numpy_state(out))


def convert_hf_whisper_encoder(model_name_or_state) -> Dict:
    """HF WhisperModel state dict -> slm_encoder params, from a state-dict
    mapping or a local ``.pt``/``.pth``/``.bin`` file holding one.  A hub
    name raises ``FileNotFoundError``: the port neither downloads nor
    imports ``transformers``."""
    if isinstance(model_name_or_state, Mapping):
        state = model_name_or_state
    elif isinstance(model_name_or_state, str) and os.path.isfile(model_name_or_state):
        state = load_torch_file(model_name_or_state)
        if "state_dict" in state:
            state = state["state_dict"]
    else:
        raise FileNotFoundError(f"no local Whisper weights at {model_name_or_state!r} "
                                "(give a state-dict file)")
    enc = {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}
    if not enc:  # already encoder-only keys
        enc = dict(state)
    return nest(to_numpy_state(enc))


# ---------------------------------------------------------------------------
# Pretrained-encoder wiring for the training entry points
# ---------------------------------------------------------------------------

def find_plbert_checkpoint(plbert_dir: str) -> Optional[str]:
    """Newest ``step_*.t7`` in a PL-BERT directory
    (ref: Utils/PLBERT/util.py:87-96 picks the max-iteration file)."""
    best, best_step = None, -1
    for name in os.listdir(plbert_dir):
        m = re.match(r"step_(\d+)\.(t7|pt|pth)$", name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(plbert_dir, name)
    return best


def _adapt(params: Mapping, cur: Optional[Mapping], name: str) -> Dict:
    """Shape-adapt converted nested params against the current module."""
    if cur is None:
        return dict(params)
    cur_flat = {k: np.asarray(v) for k, v in flatten(cur).items()}
    return nest(match_state_dict(cur_flat, flatten(params), name))


def _convert_single_module(path: str, cur: Optional[Mapping], name: str) -> Dict:
    """Convert a single-module torch checkpoint (ASR ``{'model': sd}``,
    JDC ``{'net': sd}``, or a bare state dict — ref: models.py:743-853)."""
    state = load_torch_file(path)
    for key in ("model", "net", "state_dict"):
        if isinstance(state, Mapping) and isinstance(state.get(key), Mapping):
            state = state[key]
            break
    if isinstance(state.get(name), Mapping):  # full training ckpt keyed by module
        state = state[name]
    return convert_module_state(dict(state), cur, name)


def load_pretrained_encoders(cfg, nets: nn.ModuleDict, allow_random: Optional[bool] = None
                             ) -> Dict[str, str]:
    """Load the frozen/pretrained encoders the reference recipes require into
    ``nets`` in place: ASR text aligner + JDC pitch extractor
    (ref: train_first.py:208-222, train_second.py:300-326), PL-BERT
    (ref: train_first.py:223-227, Utils/PLBERT/util.py:82-142), and the
    Whisper SLM encoder (ref: losses.py:204-214), each where ``nets`` has it.

    A configured-but-missing source raises (training against randomly
    initialised frozen encoders is silently wrong); set
    ``STYLETTS2_ALLOW_RANDOM_ENCODERS=1`` (or ``allow_random=True``) to
    downgrade to a loud warning for smoke tests.  Returns {net: source}.
    """
    if allow_random is None:
        allow_random = os.environ.get("STYLETTS2_ALLOW_RANDOM_ENCODERS") == "1"
    loaded: Dict[str, str] = {}

    def missing(msg: str):
        if allow_random:
            logger.warning("pretrained encoder missing (random init kept): %s", msg)
        else:
            raise FileNotFoundError(
                msg + " — set STYLETTS2_ALLOW_RANDOM_ENCODERS=1 to run anyway "
                "with randomly initialized frozen encoders (NOT a valid "
                "training configuration)")

    def current(name: str) -> Dict:
        return export_params({name: nets[name]})[name]

    for name, path, field in (("text_aligner", cfg.ASR_path, "ASR_path"),
                              ("pitch_extractor", cfg.F0_path, "F0_path")):
        if name not in nets:
            continue
        if not path:
            missing(f"{name}: config field {field} is empty")
        elif not os.path.exists(path):
            missing(f"{name}: {field}={path!r} does not exist")
        else:
            load_jax_params({name: nets[name]},
                            {name: _convert_single_module(path, current(name), name)})
            loaded[name] = path

    if "bert" in nets:
        src = cfg.PLBERT_dir
        ckpt = None
        if src and os.path.isdir(src):
            ckpt = find_plbert_checkpoint(src)
        elif src and os.path.isfile(src):
            ckpt = src
        if not src:
            missing("bert: config field PLBERT_dir is empty")
        elif ckpt is None:
            missing(f"bert: no step_*.t7 checkpoint under PLBERT_dir={src!r}")
        else:
            load_jax_params({"bert": nets["bert"]}, {"bert": _adapt(
                convert_plbert_checkpoint(ckpt), current("bert"), "bert")})
            loaded["bert"] = ckpt

    if "slm_encoder" in nets:
        model = cfg.model_params.slm.model
        try:
            converted = convert_hf_whisper_encoder(model)
        except Exception as exc:  # no local weights
            missing(f"slm_encoder: cannot load {model!r} ({exc})")
        else:
            load_jax_params({"slm_encoder": nets["slm_encoder"]}, {"slm_encoder": _adapt(
                converted, current("slm_encoder"), "slm_encoder")})
            loaded["slm_encoder"] = str(model)
    return loaded
