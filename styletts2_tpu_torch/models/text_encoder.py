"""Phoneme text encoder (ref: models.py:363-437).

Embedding -> ``depth`` x [weight-norm Conv1d(k=5) + channel LayerNorm +
LeakyReLU(0.2) + Dropout(0.2) in training] -> BiLSTM, with padding masked to
zero between every stage.  The dropout takes explicit keep masks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.activations import leaky_relu
from ..nn.lstm import bilstm
from ..nn.norm import layer_norm
from . import common as cm


class TextEncoder(nn.Module):
    def __init__(self, n_symbols: int, channels: int = 512, kernel_size: int = 5,
                 depth: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.embedding = nn.Embedding(n_symbols, channels)
        self.cnn = nn.ModuleList(
            nn.ModuleList([cm.WNConv1d(channels, channels, kernel_size),
                           cm.ChannelLayerNorm(channels)])
            for _ in range(depth))
        self.lstm = cm.lstm(channels, channels // 2)


DROPOUT = 0.2


def text_encoder_apply(m: TextEncoder, tokens: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       dropout_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, T) int -> (B, C, T) masked features.  ``dropout_keep``
    (depth, B, C, T) bool: the training dropout's keep masks after each CNN
    block (None: eval)."""
    b, t = tokens.shape
    if lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
    x = cm.embedding(m.embedding, tokens).transpose(1, 2)         # (B, C, T)
    keep = cm.length_mask(lengths, t)[:, None, :].to(x.dtype)     # (B, 1, T)
    x = x * keep
    pad = (m.kernel_size - 1) // 2
    for i, (conv, norm) in enumerate(m.cnn):
        x = cm.wn_conv1d(conv, x, padding=pad)
        x = layer_norm(x, norm.gamma, norm.beta, dim=1)
        x = leaky_relu(x, 0.2)
        if dropout_keep is not None:
            x = cm.dropout(x, dropout_keep[i], DROPOUT)
        x = x * keep
    x = bilstm(m.lstm, x.transpose(1, 2), lengths)               # (B, T, C)
    return x.transpose(1, 2) * keep
