"""Monotonic maximum-path (Viterbi) alignment of stage-1 training
(ref: utils.py:11-24, the Cython ``monotonic_align``).

``maximum_path`` runs ``kernels/maximum_path.py``: the plain loop on the CPU,
the K3 kernel on the card.  Both are bit-exact with the JAX package's
``ops/monotonic.py::maximum_path``.
"""

from __future__ import annotations

import torch

from ..kernels import maximum_path as K


def maximum_path(values: torch.Tensor, text_lengths: torch.Tensor,
                 mel_lengths: torch.Tensor) -> torch.Tensor:
    """Hard monotonic path maximizing the score sum: one-hot (B, T_text,
    T_mel) with one text index per valid mel frame, from (0, 0) to
    (text_len-1, mel_len-1), the text index advancing by 0 or 1 per frame.
    A constant: the values are detached."""
    return K.maximum_path(values.detach().float().contiguous(),
                          text_lengths.to(torch.int32).contiguous(),
                          mel_lengths.to(torch.int32).contiguous())
