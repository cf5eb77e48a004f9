"""Weight-norm reparameterization, computed from the raw parameters.

The modules keep torch's ``weight_v``/``weight_g`` parameter names (the
checkpoint keys) and build the effective kernel on every call, as
``styletts2_tpu/nn/param_norm.py`` does.  ``torch.nn.utils.parametrizations
.weight_norm`` is not used: it renames the parameters in ``state_dict``.
"""

from __future__ import annotations

import torch


def weight_norm_kernel(weight_v: torch.Tensor, weight_g: torch.Tensor) -> torch.Tensor:
    """``w = g * v / ||v||`` with the norm over every dim but 0 — for conv
    kernels (out, in, K) and transposed-conv kernels (in, out, K) alike."""
    dims = tuple(range(1, weight_v.ndim))
    norm = torch.sqrt(torch.sum(weight_v * weight_v, dim=dims, keepdim=True))
    return weight_g * weight_v / norm
