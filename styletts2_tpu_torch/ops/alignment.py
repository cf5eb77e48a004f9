"""Duration -> frame alignment (the reference builds ``pred_aln_trg`` with a
host-side loop, Demo/Inference_LJSpeech.ipynb cell 17)."""

from __future__ import annotations

from typing import Optional

import torch


def hard_alignment(durations: torch.Tensor, t_mel: int,
                   text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-hot (..., T_text, t_mel) f32 alignment: token i covers frames
    [cumsum[i-1], cumsum[i]).  ``durations`` (..., T_text) integer counts."""
    cum = torch.cumsum(durations, dim=-1)
    start = cum - durations
    frames = torch.arange(t_mel, device=durations.device)
    aln = ((frames >= start[..., None]) & (frames < cum[..., None])).float()
    if text_mask is not None:
        aln = aln * text_mask[..., None]
    return aln
