"""Prosody predictor: durations + F0/energy (ref: models.py:550-740).

``DurationEncoder`` alternates BiLSTM layers (over features with the style
re-concatenated each round) with style-conditioned AdaLayerNorms.  The
duration head is a BiLSTM -> Linear(d_hid, max_dur) whose sigmoid sum is the
duration; the F0/N head is a shared BiLSTM -> two stacks of three
AdainResBlk1d (the middle one 2x-upsampling) -> 1x1 conv projections.

Stage 2 trains the predictor with dropout; its keep masks are explicit
inputs (``*_keep``, bool, True = keep), shaped by ``duration_dropout_shapes``
and ``f0n_dropout_shapes``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.conv import conv1d
from ..nn.linear import linear
from ..nn.lstm import bilstm
from ..nn.norm import ada_layer_norm
from . import common as cm
from .adain_blocks import AdainResBlk1d, adain_resblk1d_apply

# training dropout rates: the duration encoder's default (stage 2 passes no
# model dropout), after the duration head's BiLSTM, and in the F0/N blocks
# (ref: models.py:592-651; the JAX package's predictor.py:121-227)
ENCODER_DROPOUT, LSTM_DROPOUT, F0N_DROPOUT = 0.1, 0.5, 0.1


class DurationEncoder(nn.Module):
    def __init__(self, sty_dim: int, d_model: int, nlayers: int):
        super().__init__()
        lstms = {}
        for i in range(nlayers):
            lstms[str(2 * i)] = cm.lstm(d_model + sty_dim, d_model // 2)
            lstms[str(2 * i + 1)] = cm.StyleAffine(sty_dim, d_model)
        self.lstms = nn.ModuleDict(lstms)
        self.nlayers = nlayers


def _f0n_stack(d_hid: int, style_dim: int) -> nn.ModuleDict:
    return nn.ModuleDict({
        "0": AdainResBlk1d(d_hid, d_hid, style_dim),
        "1": AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True),
        "2": AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim)})


class ProsodyPredictor(nn.Module):
    def __init__(self, style_dim: int, d_hid: int, nlayers: int, max_dur: int = 50):
        super().__init__()
        self.text_encoder = DurationEncoder(style_dim, d_hid, nlayers)
        self.lstm = cm.lstm(d_hid + style_dim, d_hid // 2)
        self.duration_proj = nn.ModuleDict({"linear_layer": nn.Linear(d_hid, max_dur)})
        self.shared = cm.lstm(d_hid + style_dim, d_hid // 2)
        self.F0 = _f0n_stack(d_hid, style_dim)
        self.N = _f0n_stack(d_hid, style_dim)
        self.F0_proj = nn.Conv1d(d_hid // 2, 1, 1)
        self.N_proj = nn.Conv1d(d_hid // 2, 1, 1)


def duration_dropout_shapes(m: ProsodyPredictor, b: int, t: int
                            ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The shapes of ``prosody_duration_apply``'s keep masks for B texts of
    T tokens: the duration encoder's (nlayers, B, T, d_hid) and the head's
    (B, T, d_hid)."""
    d_hid = m.duration_proj["linear_layer"].in_features
    return (m.text_encoder.nlayers, b, t, d_hid), (b, t, d_hid)


def f0n_dropout_shapes(m: ProsodyPredictor, b: int, t: int) -> List[Tuple[Tuple[int, ...], ...]]:
    """The shapes of ``prosody_f0n_apply``'s keep masks for B inputs of T
    frames: a pair per block, F0's three blocks then N's."""
    out = []
    for stack in (m.F0, m.N):
        cur = t
        for blk in stack.values():
            c_in, c_out = blk.conv1.weight_v.shape[1], blk.conv1.weight_v.shape[0]
            cur = cur * 2 if blk.upsample else cur
            out.append(((b, c_in, cur), (b, c_out, cur)))
    return out


def duration_encoder_apply(m: DurationEncoder, x: torch.Tensor, style: torch.Tensor,
                           lengths: torch.Tensor,
                           dropout_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, C, T) bert-encoded text, style (B, S) -> (B, T, d_model + S).
    ``dropout_keep`` (nlayers, B, T, d_model): the training dropout after
    each BiLSTM (None: eval)."""
    b, _, t = x.shape
    keep = cm.length_mask(lengths, t)[..., None].to(x.dtype)       # (B, T, 1)
    s_t = style[:, None, :].expand(b, t, style.shape[-1])
    h = torch.cat([x.transpose(1, 2), s_t], dim=-1) * keep
    for i in range(m.nlayers):
        h = bilstm(m.lstms[str(2 * i)], h, lengths)
        if dropout_keep is not None:
            h = cm.dropout(h, dropout_keep[i], ENCODER_DROPOUT)
        h = ada_layer_norm(m.lstms[str(2 * i + 1)], h, style)
        h = torch.cat([h, s_t], dim=-1) * keep
    return h


def duration_logits(m: ProsodyPredictor, d: torch.Tensor, lengths: torch.Tensor,
                    dropout_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The duration head: BiLSTM -> (training dropout) -> Linear,
    d (B, T, d_hid + S) -> logits (B, T, max_dur)."""
    proj = m.duration_proj["linear_layer"]
    x = cm.dropout(bilstm(m.lstm, d, lengths), dropout_keep, LSTM_DROPOUT)
    return linear(x, proj.weight, proj.bias)


def prosody_duration_apply(m: ProsodyPredictor, texts: torch.Tensor, style: torch.Tensor,
                           lengths: torch.Tensor, alignment: torch.Tensor,
                           encoder_keep: Optional[torch.Tensor] = None,
                           lstm_keep: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """texts (B, C, T) bert-encoded, style (B, S), alignment (B, T, T_mel)
    -> the duration logits (B, T, max_dur) and the prosody encoding
    (B, d_hid + S, T_mel) (ref: models.py:592-631); the keep masks as in
    ``duration_dropout_shapes`` (None: eval)."""
    d = duration_encoder_apply(m.text_encoder, texts, style, lengths, encoder_keep)
    return duration_logits(m, d, lengths, lstm_keep), d.transpose(1, 2) @ alignment


def predict_durations(m: ProsodyPredictor, d: torch.Tensor, lengths: torch.Tensor,
                      last_token_pad: int = 0) -> torch.Tensor:
    """Duration head (ref: Demo/Inference_LJSpeech.ipynb cell 17): sigmoid
    sum over ``max_dur`` bins, round half to even, clamp at 1, zero past
    ``lengths``, and ``last_token_pad`` frames added to each last token.
    d (B, T, d_hid + S) -> (B, T) int32."""
    t = d.shape[1]
    duration = torch.sigmoid(duration_logits(m, d, lengths)).sum(dim=-1)
    mask = cm.length_mask(lengths, t)
    pred = torch.where(mask, torch.clamp(torch.round(duration), min=1.0),
                       torch.zeros_like(duration))
    if last_token_pad:
        last = torch.arange(t, device=d.device)[None, :] == (lengths - 1)[:, None]
        pred = pred + last_token_pad * last
    return pred.to(torch.int32)


def prosody_f0n_apply(m: ProsodyPredictor, x: torch.Tensor, s: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None,
                      dropout_keep: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, C+S, T) prosody encoding -> F0 and energy curves (B, 2T) each
    (ref: models.py:638-651).  ``dropout_keep`` (training): the blocks'
    keep-mask pairs as in ``f0n_dropout_shapes`` (None: eval)."""
    h = bilstm(m.shared, x.transpose(1, 2), lengths).transpose(1, 2)

    def head(stack: nn.ModuleDict, proj: nn.Conv1d, first: int) -> torch.Tensor:
        y, cur = h, lengths
        for i, blk in enumerate(stack.values()):
            keep = None if dropout_keep is None else dropout_keep[first + i]
            y = adain_resblk1d_apply(blk, y, s, lengths=cur, dropout_keep=keep,
                                     dropout_p=F0N_DROPOUT)
            if blk.upsample and cur is not None:
                cur = cur * 2
        return conv1d(y, proj.weight, proj.bias)[:, 0, :]

    return head(m.F0, m.F0_proj, 0), head(m.N, m.N_proj, len(m.F0))
