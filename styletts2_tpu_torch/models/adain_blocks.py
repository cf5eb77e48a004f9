"""Style-conditioned 1-D residual blocks (ref: models.py:440-547).

``AdainResBlk1d``: 2 x (AdaIN -> LeakyReLU(0.2) -> weight-norm conv) residual
with optional 2x upsampling (nearest-neighbour on the shortcut, depthwise
stride-2 transposed conv "pool" on the residual) and 1/sqrt(2) scaling.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.activations import leaky_relu
from ..nn.conv import conv_transpose1d, interpolate_nearest_2x
from ..nn.norm import adain1d
from . import common as cm


class AdainResBlk1d(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, style_dim: int,
                 upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.conv1 = cm.WNConv1d(dim_in, dim_out, 3)
        self.conv2 = cm.WNConv1d(dim_out, dim_out, 3)
        self.norm1 = cm.StyleAffine(style_dim, dim_in)
        self.norm2 = cm.StyleAffine(style_dim, dim_out)
        if dim_in != dim_out:
            self.conv1x1 = cm.WNConv1d(dim_in, dim_out, 1, bias=False)
        if upsample:
            self.pool = cm.WNConvTranspose1d(dim_in, dim_in, 3, groups=dim_in)


def adain_resblk1d_apply(m: AdainResBlk1d, x: torch.Tensor, s: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None,
                         dropout_keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         dropout_p: float = 0.1) -> torch.Tensor:
    """x (B, C_in, T), s (B, S), lengths (B,) valid frames at the input rate.
    ``dropout_keep`` (training): the keep masks of the dropout before each
    conv, (B, C_in, T_out) and (B, C_out, T_out) bool, at rate ``dropout_p``
    (ref: models.py:499-507); None: eval.

    Pad positions are re-zeroed after every non-conv stage: the norms' output
    there is nonzero, and the kernel-3 convs would leak it into the last
    valid frames where exact-length inference sees zero conv padding.
    """
    keep = keep_out = None
    if lengths is not None:
        keep = cm.length_mask(lengths, x.shape[-1])[:, None, :].to(x.dtype)
        keep_out = keep
        x = x * keep
    sc = interpolate_nearest_2x(x) if m.upsample else x
    if hasattr(m, "conv1x1"):
        sc = cm.wn_conv1d(m.conv1x1, sc)
    h = adain1d(m.norm1, x, s, keep=None if keep is None else keep[:, 0, :])
    h = leaky_relu(h, 0.2)
    if keep is not None:
        h = h * keep
    if m.upsample:
        h = conv_transpose1d(h, m.pool.weight(), m.pool.bias, stride=2, padding=1,
                             output_padding=1, groups=h.shape[1])
        if lengths is not None:
            keep_out = cm.length_mask(lengths * 2, h.shape[-1])[:, None, :].to(h.dtype)
            h = h * keep_out
    if dropout_keep is not None:
        h = cm.dropout(h, dropout_keep[0], dropout_p)
    h = cm.wn_conv1d(m.conv1, h, padding=1)
    h = adain1d(m.norm2, h, s, keep=None if keep_out is None else keep_out[:, 0, :])
    h = leaky_relu(h, 0.2)
    if keep_out is not None:
        h = h * keep_out
    if dropout_keep is not None:
        h = cm.dropout(h, dropout_keep[1], dropout_p)
    h = cm.wn_conv1d(m.conv2, h, padding=1)
    out = (h + sc) / math.sqrt(2.0)
    return out if keep_out is None else out * keep_out
