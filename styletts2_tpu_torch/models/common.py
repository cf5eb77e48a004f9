"""Shared building blocks for the model zoo.

Conventions used by every model module in this package:

- A net is an ``nn.Module`` whose ``state_dict`` keys equal the flattened,
  dot-joined keys of the JAX package's parameter tree for the same net (the
  reference torch checkpoint names), so one weight set loads into both.
- Modules hold parameters and static shape settings; the computation lives
  in ``*_apply`` functions named after their JAX counterparts.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.conv import conv1d, conv2d
from ..nn.param_norm import spectral_norm_kernel, weight_norm_kernel


def _param(*shape: int) -> nn.Parameter:
    # values come from models.zoo.init_random_ or a loaded state_dict
    return nn.Parameter(torch.zeros(*shape))


class WeightNormed(nn.Module):
    """``weight_v``/``weight_g`` (+ optional ``bias``) as torch's weight_norm
    stores them; ``weight()`` is the effective kernel."""

    def __init__(self, shape: Sequence[int], bias: Optional[int]):
        super().__init__()
        self.weight_v = _param(*shape)
        self.weight_g = _param(shape[0], *([1] * (len(shape) - 1)))
        if bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = _param(bias)

    def weight(self) -> torch.Tensor:
        return weight_norm_kernel(self.weight_v, self.weight_g)


class WNConv1d(WeightNormed):
    """Weight-normed Conv1d: kernel (out, in/groups, K)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, groups: int = 1,
                 bias: bool = True):
        super().__init__((out_ch, in_ch // groups, kernel), out_ch if bias else None)


class WNConvTranspose1d(WeightNormed):
    """Weight-normed ConvTranspose1d: kernel (in, out/groups, K)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, groups: int = 1,
                 bias: bool = True):
        super().__init__((in_ch, out_ch // groups, kernel), out_ch if bias else None)


class SNConv2d(nn.Module):
    """Spectral-norm Conv2d as torch's spectral_norm stores it: the
    ``weight_orig`` parameter (out, in/groups, KH, KW), optional ``bias``,
    and the power-iteration buffers ``weight_u`` (out,) and ``weight_v``
    (in/groups * KH * KW,)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int], groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight_orig = _param(out_ch, in_ch // groups, *kernel)
        if bias:
            self.bias = _param(out_ch)
        else:
            self.register_parameter("bias", None)
        self.register_buffer("weight_u", torch.zeros(out_ch))
        self.register_buffer("weight_v", torch.zeros((in_ch // groups) * math.prod(kernel)))

    def weight(self) -> torch.Tensor:
        """One stateless power iteration from the stored vectors (the JAX
        package's ``_sn_kernel``): the vectors themselves are constants, the
        refined ones carry gradients to ``weight_orig``."""
        w, _, _ = spectral_norm_kernel(self.weight_orig, self.weight_u.detach(),
                                       self.weight_v.detach(), n_power_iterations=1)
        return w

    @torch.no_grad()
    def converge_(self, iterations: int = 15) -> None:
        """Run the power iteration to convergence from the stored ``weight_u``
        and store (u, v): random vectors give a wildly wrong sigma."""
        u = self.weight_u / torch.clamp(torch.linalg.vector_norm(self.weight_u), min=1e-12)
        _, u, v = spectral_norm_kernel(self.weight_orig, u, self.weight_v, iterations)
        self.weight_u.copy_(u)
        self.weight_v.copy_(v)


class StyleAffine(nn.Module):
    """AdaIN1d / AdaLayerNorm parameters: ``fc`` projects the style to
    (gamma, beta)."""

    def __init__(self, style_dim: int, channels: int):
        super().__init__()
        self.fc = nn.Linear(style_dim, channels * 2)


class ChannelLayerNorm(nn.Module):
    """The reference's channels-first LayerNorm (``gamma``/``beta`` keys)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = _param(channels)
        self.beta = _param(channels)


def lstm(input_size: int, hidden: int) -> nn.LSTM:
    return nn.LSTM(input_size, hidden, num_layers=1, batch_first=True,
                   bidirectional=True)


def wn_conv1d(m: WeightNormed, x: torch.Tensor, **kw) -> torch.Tensor:
    return conv1d(x, m.weight(), m.bias, **kw)


def sn_conv2d(m: SNConv2d, x: torch.Tensor, **kw) -> torch.Tensor:
    return conv2d(x, m.weight(), m.bias, **kw)


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], p: float) -> torch.Tensor:
    """Inverted dropout with a given keep mask (bool, x's shape or
    broadcastable); ``keep=None`` is the identity (eval, or no dropout)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def embedding(m: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    return m.weight[ids]


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, T) bool, True at valid positions ``< lengths``."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def autocast(m: nn.Module, *xs):
    """Cast floating inputs to the module's parameter dtype (a no-op in f32)."""
    dt = next(m.parameters()).dtype
    out = tuple(a.to(dt) if a is not None and a.is_floating_point() else a for a in xs)
    return out if len(out) > 1 else out[0]
