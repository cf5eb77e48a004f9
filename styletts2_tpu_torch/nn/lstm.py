"""Bidirectional LSTM with packed-sequence semantics, and one LSTMCell step.

``styletts2_tpu/nn/lstm.py`` reproduces ``nn.LSTM`` on a packed sequence with
masked scans; here the packed sequence is used directly: the reverse
direction starts at each sample's true end and padded positions are zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


def bilstm(lstm: nn.LSTM, x: torch.Tensor,
           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, I) -> (B, T, 2H) through a ``batch_first`` bidirectional LSTM.
    Mixed dtypes promote, as the JAX scan's products do: an f32 input runs
    bf16 weights as f32 (the duration encoder under a bf16 zoo)."""
    dt = torch.promote_types(x.dtype, lstm.weight_ih_l0.dtype)
    x = x.to(dt)
    run = lstm
    if lstm.weight_ih_l0.dtype != dt:
        params = {n: p.to(dt) for n, p in lstm.named_parameters()}

        def run(inp):      # a PackedSequence is a tuple: pass it as one argument
            return torch.func.functional_call(lstm, params, (inp,))
    if lengths is None:
        out, _ = run(x)
        return out
    packed = pack_padded_sequence(x, lengths.to("cpu", torch.int64),
                                  batch_first=True, enforce_sorted=False)
    out, _ = run(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=x.shape[1])
    return out


def lstm_step(cell: nn.LSTMCell, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``nn.LSTMCell`` step, gates ordered i, f, g, o, summed in the JAX
    package's order (``styletts2_tpu/nn/lstm.py::lstm_step``)."""
    gates = (x @ cell.weight_ih.t() + cell.bias_ih + h @ cell.weight_hh.t()
             + cell.bias_hh)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c
