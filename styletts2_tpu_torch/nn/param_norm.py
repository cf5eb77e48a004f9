"""Weight-norm and spectral-norm reparameterizations, computed from the raw
parameters.

The modules keep torch's ``weight_v``/``weight_g`` parameter names (the
checkpoint keys) and build the effective kernel on every call, as
``styletts2_tpu/nn/param_norm.py`` does.  ``torch.nn.utils.parametrizations
.weight_norm`` is not used: it renames the parameters in ``state_dict``.
Spectral norm keeps ``weight_orig`` with the ``weight_u``/``weight_v``
power-iteration vectors; ``torch.nn.utils.spectral_norm`` is not used
either: besides renaming, it cuts the refined vectors from the gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch


def weight_norm_kernel(weight_v: torch.Tensor, weight_g: torch.Tensor) -> torch.Tensor:
    """``w = g * v / ||v||`` with the norm over every dim but 0 — for conv
    kernels (out, in, K) and transposed-conv kernels (in, out, K) alike."""
    dims = tuple(range(1, weight_v.ndim))
    norm = torch.sqrt(torch.sum(weight_v * weight_v, dim=dims, keepdim=True))
    return weight_g * weight_v / norm


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def spectral_norm_kernel(weight_orig: torch.Tensor, weight_u: torch.Tensor,
                         weight_v: torch.Tensor, n_power_iterations: int = 0,
                         eps: float = 1e-12
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(w / sigma, u, v)``: ``n_power_iterations`` refinements of (v, u)
    from the given vectors, then ``sigma = u^T W v`` with W the kernel
    flattened to (out, -1).  Gradients flow through the refined u and v to
    ``weight_orig``; pass the stored vectors detached."""
    w_mat = weight_orig.reshape(weight_orig.shape[0], -1)
    u, v = weight_u, weight_v
    for _ in range(n_power_iterations):
        v = _normalize(w_mat.t() @ u, eps)
        u = _normalize(w_mat @ v, eps)
    sigma = u @ (w_mat @ v)
    return weight_orig / sigma, u, v
