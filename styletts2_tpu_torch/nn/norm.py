"""Normalization layers (channels-first) and the AdaIN family.

Numerics follow ``styletts2_tpu/nn/norm.py``: biased variance, eps inside the
square root, masked statistics taken over valid frames only, and statistics
and normalisation in f32 whatever the input's dtype, the result returned in
that dtype before the affine (a bf16 mean/var over a long axis loses bits).
"""

from __future__ import annotations

from typing import Optional

import torch

from .linear import linear


def layer_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
               beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
               dim: int = -1) -> torch.Tensor:
    """LayerNorm over one axis (weight/bias broadcast along that axis)."""
    xf = x.float()
    mean = xf.mean(dim=dim, keepdim=True)
    var = xf.var(dim=dim, keepdim=True, unbiased=False)
    y = ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
    if gamma is not None:
        shape = [1] * x.ndim
        shape[dim] = x.shape[dim]
        y = y * gamma.reshape(shape)
        if beta is not None:
            y = y + beta.reshape(shape)
    return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over all spatial axes of (B, C, *spatial)."""
    dims = tuple(range(2, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, keepdim=True, unbiased=False)
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)


def masked_instance_norm1d(x: torch.Tensor, keep: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over valid frames only: ``keep`` (B, T) marks validity."""
    xf = x.float()
    k = keep[:, None, :].float()
    n = torch.clamp(k.sum(dim=2, keepdim=True), min=1.0)
    mean = (xf * k).sum(dim=2, keepdim=True) / n
    var = (torch.square(xf - mean) * k).sum(dim=2, keepdim=True) / n
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)


def style_affine(fc, s: torch.Tensor):
    """(gamma, beta) (B, C) each from a style projection ``fc`` (2C, S)."""
    h = linear(s, fc.weight, fc.bias)
    return torch.chunk(h, 2, dim=-1)


def adain1d(m, x: torch.Tensor, s: torch.Tensor, eps: float = 1e-5,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Adaptive instance norm on (B, C, T) conditioned on style (B, S);
    ``m.fc`` is the style projection."""
    gamma, beta = style_affine(m.fc, s)
    norm = instance_norm(x, eps) if keep is None else masked_instance_norm1d(x, keep, eps)
    return (1.0 + gamma[:, :, None]) * norm + beta[:, :, None]


def ada_layer_norm(m, x: torch.Tensor, s: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Style-conditioned LayerNorm over the last axis of (B, T, C)."""
    gamma, beta = style_affine(m.fc, s)
    y = layer_norm(x, eps=eps, dim=-1)
    return (1.0 + gamma[:, None, :]) * y + beta[:, None, :]
