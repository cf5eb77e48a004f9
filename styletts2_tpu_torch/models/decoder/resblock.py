"""AdaINResBlock1 — the Snake-activated MRF residual block of the iSTFTNet
generator (ref: Modules/istftnet.py:27-81).

Three rounds of [AdaIN -> Snake -> dilated conv -> AdaIN -> Snake -> conv],
each with per-channel learnable Snake alphas, accumulated residually.
``adain_resblock1_apply`` is the plain form; ``adain_resblock1_fused`` runs
each of the six AdaIN -> Snake -> conv rounds as one ``kernels.mrf_round``
call and chains the instance-norm statistics through its partials.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...kernels.mrf_round import masked_stats, mrf_round, stats_from_partials
from ...nn.norm import style_affine
from ...ops.fused import adain_snake
from .. import common as cm


def _get_padding(kernel: int, dilation: int) -> int:
    return (kernel * dilation - dilation) // 2


class AdainResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), style_dim: int = 64):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(
            cm.WNConv1d(channels, channels, kernel_size) for _ in range(3))
        self.convs2 = nn.ModuleList(
            cm.WNConv1d(channels, channels, kernel_size) for _ in range(3))
        self.adain1 = nn.ModuleList(cm.StyleAffine(style_dim, channels) for _ in range(3))
        self.adain2 = nn.ModuleList(cm.StyleAffine(style_dim, channels) for _ in range(3))
        self.alpha1 = nn.ParameterList(nn.Parameter(torch.ones(1, channels, 1))
                                       for _ in range(3))
        self.alpha2 = nn.ParameterList(nn.Parameter(torch.ones(1, channels, 1))
                                       for _ in range(3))


def adain_resblock1_apply(m: AdainResBlock1, x: torch.Tensor, s: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, C, T), s (B, S); ``lengths`` (B,) restricts the norm statistics
    to valid frames."""
    k = m.kernel_size
    for i in range(3):
        d = m.dilation[i]
        h = adain_snake(m.adain1[i], x, s, m.alpha1[i], lengths=lengths)
        h = cm.wn_conv1d(m.convs1[i], h, padding=_get_padding(k, d), dilation=d)
        h = adain_snake(m.adain2[i], h, s, m.alpha2[i], lengths=lengths)
        h = cm.wn_conv1d(m.convs2[i], h, padding=_get_padding(k, 1))
        x = x + h
    return x


def _round(x, stats, affine, alpha, conv, s, lengths, k, d, residual=None):
    """One round in x's dtype; the AdaIN/Snake parameters and the bias go in
    f32, as the JAX package's ``pack_plane`` makes them."""
    gamma, beta = (a.float().contiguous() for a in style_affine(affine.fc, s))
    return mrf_round(x, stats[0], stats[1], gamma, beta, alpha.reshape(-1).float(),
                     conv.weight(), conv.bias.float(), lengths, k=k, d=d, residual=residual)


def adain_resblock1_fused(m: AdainResBlock1, x: torch.Tensor, s: torch.Tensor,
                          lengths: torch.Tensor,
                          stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The same math as ``adain_resblock1_apply`` in six ``mrf_round`` calls.

    ``lengths`` (B,) int32 valid frames; ``stats`` the (mean, rstd) of ``x``
    over them, when the caller already has it (a stage's resblocks share
    one).  Returns ``(out, (mean, rstd) of out)``.
    """
    if stats is None:
        stats = masked_stats(x, lengths)
    t = x.shape[-1]
    k = m.kernel_size
    for i in range(3):
        h, parts = _round(x, stats, m.adain1[i], m.alpha1[i], m.convs1[i], s,
                          lengths, k, m.dilation[i])
        x, parts = _round(h, stats_from_partials(parts, lengths, t), m.adain2[i],
                          m.alpha2[i], m.convs2[i], s, lengths, k, 1, residual=x)
        stats = stats_from_partials(parts, lengths, t)
    return x, stats
