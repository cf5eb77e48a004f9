"""The AdaIN1d -> Snake pair of the vocoder MRF resblocks
(ref: Modules/istftnet.py:27-81), as a plain composition.

This is the unfused resblock's form.  The fused form runs whole rounds
(norm -> affine -> snake -> dilated conv) through ``kernels/mrf_round.py``;
the TPU's opt-in ``adain_snake_pallas`` kernel is ported with the training
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.activations import snake
from ..nn.norm import style_affine


def adain_snake(adain, x: torch.Tensor, s: torch.Tensor, alpha: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``snake(adain1d(adain, x, s), alpha)`` on (B, C, T); ``alpha`` is the
    reference's (1, C, 1) parameter; ``lengths`` (B,) restricts the norm
    statistics to valid frames.  Centered two-pass variance."""
    gamma, beta = style_affine(adain.fc, s)                    # (B, C) each
    t = x.shape[-1]
    if lengths is None:
        mean = x.mean(dim=-1)
        var = torch.square(x - mean[:, :, None]).mean(dim=-1)
    else:
        keep = (torch.arange(t, device=x.device)[None, None, :]
                < lengths[:, None, None]).to(x.dtype)
        n = torch.clamp(keep[:, 0, :].sum(-1), min=1.0)[:, None]
        mean = torch.sum(x * keep, dim=-1) / n
        var = torch.sum(torch.square(x - mean[:, :, None]) * keep, dim=-1) / n
    rstd = torch.rsqrt(var + 1e-5)
    u = ((x - mean[:, :, None]) * rstd[:, :, None] * (1.0 + gamma)[:, :, None]
         + beta[:, :, None])
    return snake(u, alpha.reshape(1, -1, 1))
