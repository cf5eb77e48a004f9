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
