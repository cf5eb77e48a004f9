"""Mel -> style vector encoder (ref: models.py:150-227).

A spectral-norm Conv2d stem, four spectral-norm ResBlks with stride-2
downsampling, a 5x5 valid conv, a global average pool (masked over valid
frames when lengths are given) and a linear head.  The spare
``discriminator2d`` of the reference is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.activations import leaky_relu
from ..nn.conv import avg_pool2d
from ..nn.linear import linear
from . import common as cm


class ResBlk(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, downsample: bool = True):
        super().__init__()
        self.downsample = downsample
        self.conv1 = cm.SNConv2d(dim_in, dim_in, (3, 3))
        self.conv2 = cm.SNConv2d(dim_in, dim_out, (3, 3))
        if downsample:
            self.downsample_res = nn.ModuleDict(
                {"conv": cm.SNConv2d(dim_in, dim_in, (3, 3), groups=dim_in)})
        if dim_in != dim_out:
            self.conv1x1 = cm.SNConv2d(dim_in, dim_out, (1, 1), bias=False)


class StyleEncoder(nn.Module):
    def __init__(self, dim_in: int = 64, style_dim: int = 128, max_conv_dim: int = 512,
                 repeat_num: int = 4):
        super().__init__()
        self.repeat_num = repeat_num
        shared = {"0": cm.SNConv2d(1, dim_in, (3, 3))}
        d = dim_in
        for i in range(repeat_num):
            d_out = min(d * 2, max_conv_dim)
            shared[str(i + 1)] = ResBlk(d, d_out)
            d = d_out
        shared[str(repeat_num + 2)] = cm.SNConv2d(d, d, (5, 5))
        self.shared = nn.ModuleDict(shared)
        self.unshared = nn.Linear(d, style_dim)


def _downsample_half(x: torch.Tensor) -> torch.Tensor:
    """DownSample('half'): replicate-pad odd spatial dims, then a 2x2 mean
    pool (ref: models.py:110-128)."""
    if x.shape[-1] % 2:
        x = torch.cat([x, x[..., -1:]], dim=-1)
    if x.shape[-2] % 2:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    return avg_pool2d(x, 2)


def resblk_apply(m: ResBlk, x: torch.Tensor) -> torch.Tensor:
    sc = x
    if hasattr(m, "conv1x1"):
        sc = cm.sn_conv2d(m.conv1x1, sc)
    if m.downsample:
        sc = _downsample_half(sc)
    h = leaky_relu(x, 0.2)
    h = cm.sn_conv2d(m.conv1, h, padding=1)
    if m.downsample:
        h = cm.sn_conv2d(m.downsample_res["conv"], h, stride=2, padding=1,
                         groups=h.shape[1])
    h = leaky_relu(h, 0.2)
    h = cm.sn_conv2d(m.conv2, h, padding=1)
    return (sc + h) / math.sqrt(2.0)


def style_encoder_apply(m: StyleEncoder, mel: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel (B, 1, n_mels, T) normalized log-mel, lengths (B,) valid frames
    or None -> style vectors (B, style_dim)."""
    r = m.repeat_num
    if mel.shape[-1] < 5 * 2 ** r or mel.shape[-2] < 5 * 2 ** r:
        raise ValueError(f"style encoder input {tuple(mel.shape)} too small: needs >= "
                         f"{5 * 2 ** r} mel bins and frames")
    mel = cm.autocast(m, mel)
    x = cm.sn_conv2d(m.shared["0"], mel, padding=1)
    for i in range(r):
        x = resblk_apply(m.shared[str(i + 1)], x)
    x = leaky_relu(x, 0.2)
    x = cm.sn_conv2d(m.shared[str(r + 2)], x)                  # valid 5x5 conv
    if lengths is None:
        h = x.mean(dim=(2, 3))
    else:
        t_down = lengths
        for _ in range(r):
            t_down = (t_down + 1) // 2                         # ceil halving
        t_down = torch.clamp(t_down - 4, min=1)                # the valid conv trims 4
        keep = (torch.arange(x.shape[-1], device=x.device)[None, :]
                < t_down[:, None])[:, None, None, :]
        h = (x * keep).sum(dim=(2, 3)) / (x.shape[2] * t_down[:, None])
    h = leaky_relu(h, 0.2)
    return linear(h, m.unshared.weight, m.unshared.bias)
