"""Bidirectional LSTM with packed-sequence semantics.

``styletts2_tpu/nn/lstm.py`` reproduces ``nn.LSTM`` on a packed sequence with
masked scans; here the packed sequence is used directly: the reverse
direction starts at each sample's true end and padded positions are zero.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


def bilstm(lstm: nn.LSTM, x: torch.Tensor,
           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, I) -> (B, T, 2H) through a ``batch_first`` bidirectional LSTM."""
    if lengths is None:
        out, _ = lstm(x)
        return out
    packed = pack_padded_sequence(x, lengths.to("cpu", torch.int64),
                                  batch_first=True, enforce_sorted=False)
    out, _ = lstm(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])
    return out
