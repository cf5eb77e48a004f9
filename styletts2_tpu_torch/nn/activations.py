"""Activation functions.

The JAX package evaluates sines through a range-reduced polynomial because
XLA's ``sin`` is slow on the TPU's vector unit; the port uses the exact
``torch.sin`` (the two agree to ~6e-7, PARITY.md rows 2, 3 and 5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, x * negative_slope)


def sin_turns(r: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*r) for a phase in turns, reduced in turns first.

    ``torch.sin(2*pi*r)`` on an accumulator near 1e2 turns rounds the
    product to the f32 ulp of ~6e2 radians; subtracting ``round(r)`` first
    keeps the argument in [-pi, pi] and the error at the input's own ulp.
    """
    return torch.sin((2.0 * math.pi) * (r - torch.round(r)))


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake1D: ``x + sin(alpha*x)^2 / alpha`` (ref: Modules/istftnet.py:69),
    computed in f32 and returned in x's dtype, as the JAX package's."""
    xf, af = x.float(), alpha.float()
    return (xf + torch.sin(af * xf) ** 2 / af).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU (HF transformers 'gelu_new')."""
    return F.gelu(x, approximate="tanh")
