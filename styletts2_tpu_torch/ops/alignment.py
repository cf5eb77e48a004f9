"""Duration -> frame alignment.

- ``hard_alignment``: the inference-time ``pred_aln_trg`` matrix (the
  reference builds it with a host-side loop, Demo/Inference_LJSpeech.ipynb
  cell 17).
- ``gaussian_alignment``: the SLM adversarial step's differentiable soft
  alignment (ref: Modules/slmadv.py:112-134).  The reference's per-sample
  grouped conv1d becomes one einsum, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def gaussian_alignment(duration_logits: torch.Tensor, text_lengths: torch.Tensor,
                       t_mel: int, sigma: float = 1.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """duration_logits (B, T_text, max_dur), text_lengths (B,) -> the soft
    alignment (B, T_text, t_mel) and the predicted frame counts (B,) int32.

    With ``x = sigmoid(logits)`` over the valid tokens, ``dur = x.sum(-1)``
    and ``loc = cumsum(dur) - dur / 2``, the reference's grouped conv is
    ``out[i, t] = sum_{k <= t} logits[i, k] exp(-(t - k + 1 - loc_i)^2 /
    (2 sigma^2))``, then a softmax over the valid tokens; frames past the
    rounded (half to even) total and padded tokens are zeroed.  The
    (B, T_text, t_mel, max_dur) Gaussian is materialised, as in the JAX
    package."""
    b, t_text, max_dur = duration_logits.shape
    dev = duration_logits.device
    token_mask = torch.arange(t_text, device=dev)[None, :] < text_lengths[:, None]
    keep = token_mask[..., None].to(duration_logits.dtype)
    dur = (torch.sigmoid(duration_logits) * keep).sum(dim=-1)       # (B, T_text)
    lengths = torch.round(dur.sum(dim=-1)).to(torch.int32)
    loc = torch.cumsum(dur, dim=-1) - dur / 2.0

    t = torch.arange(t_mel, dtype=torch.float32, device=dev)
    k = torch.arange(max_dur, dtype=torch.float32, device=dev)
    offset = k[None, None, :] - t[None, :, None] - 1.0                # (1, T, K)
    centers = offset[None] + loc[..., None, None]                     # (B, T_text, T, K)
    gauss = torch.exp(-0.5 * torch.square(centers) / (sigma ** 2))
    gauss = gauss * (k[None, None, :] <= t[None, :, None])[None]
    out = torch.einsum("bik,bitk->bit", duration_logits * keep, gauss)
    out = torch.where(token_mask[:, :, None], out,
                      torch.full_like(out, torch.finfo(out.dtype).min))
    attn = torch.softmax(out, dim=1)
    frame_mask = torch.arange(t_mel, device=dev)[None, :] < lengths[:, None]
    return attn * frame_mask[:, None, :] * token_mask[:, :, None], lengths
