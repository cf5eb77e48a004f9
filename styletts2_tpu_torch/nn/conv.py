"""Convolutions and pooling with torch-layout kernels, channels-first
activations.

The JAX package's MXU-shaped rewrites (``conv1d_folded``,
``conv_transpose1d_subpixel``) are TPU layouts and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """x (B, C_in, T), w (C_out, C_in/groups, K)."""
    return F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 1,
                     padding: int = 0, output_padding: int = 0, groups: int = 1,
                     dilation: int = 1) -> torch.Tensor:
    """x (B, C_in, T), w (C_in, C_out/groups, K)."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding, groups=groups,
                              dilation=dilation)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """x (B, C_in, H, W), w (C_out, C_in/groups, KH, KW)."""
    return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def avg_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping mean pool over the two trailing axes; a ragged edge
    is dropped (floor mode)."""
    return F.avg_pool2d(x, window)


def interpolate_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='nearest') on the trailing axis."""
    return torch.repeat_interleave(x, 2, dim=-1)


def interpolate_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """``F.interpolate(mode='linear', align_corners=False)`` to ``out_len``
    over the trailing axis, written out as the JAX package's
    ``nn/conv.py::interpolate_linear`` computes it: source positions
    ``(i + 0.5) * t_in/out_len - 0.5`` in f32, clamped into the input, then
    a gather of the two neighbours.  ``F.interpolate`` rounds its positions
    differently in the last bits."""
    t_in = x.shape[-1]
    scale = torch.tensor(t_in / out_len, dtype=torch.float32)
    pos = (torch.arange(out_len, dtype=torch.float32) + 0.5) * scale - 0.5
    pos = torch.clamp(pos, 0.0, t_in - 1).to(x.device)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=t_in - 1)
    frac = (pos - lo).to(x.dtype)
    xl = torch.index_select(x, -1, lo)
    xh = torch.index_select(x, -1, hi)
    return xl + (xh - xl) * frac
