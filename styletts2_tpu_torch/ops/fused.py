"""The AdaIN1d -> Snake pair of the vocoder MRF resblocks
(ref: Modules/istftnet.py:27-81).

``adain_snake`` projects the style to (gamma, beta) and hands the pair to
``kernels/adain_snake.py``: the plain composition on the CPU, the K1f/K1b
kernels inside an autograd Function on the card.  The plain resblock and
the training decoder run through it; the serving decoder's fused form runs
whole rounds (norm -> affine -> snake -> dilated conv) through
``kernels/mrf_round.py`` instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import adain_snake as K
from ..nn.norm import style_affine


def adain_snake(adain, x: torch.Tensor, s: torch.Tensor, alpha: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``snake(adain1d(adain, x, s), alpha)`` on (B, C, T); ``alpha`` is the
    reference's (1, C, 1) parameter; ``lengths`` (B,) restricts the norm
    statistics to valid frames.  Centered two-pass variance."""
    gamma, beta = style_affine(adain.fc, s)                    # (B, C) each
    return K.adain_snake(x.contiguous(), gamma.contiguous(), beta.contiguous(),
                         alpha.reshape(-1),
                         None if lengths is None else lengths.to(torch.int32).contiguous())
