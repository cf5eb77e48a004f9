"""Multi-resolution mel-STFT reconstruction loss (ref: losses.py:9-96).

Each resolution computes 24 kHz log-mels of the prediction and the target
and takes the L1 spectral-convergence ratio ||y - x||_1 / ||y||_1; the
resolutions are averaged.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..audio.mel import LogMelConfig, log_mel_spectrogram

RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (1024, 120, 600),
    (2048, 240, 1200),
    (512, 50, 240),
)


def stft_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    cfg = LogMelConfig(n_fft=n_fft, hop_length=hop, win_length=win, fbank_sample_rate=24000)
    x_mag = log_mel_spectrogram(x, cfg)
    y_mag = log_mel_spectrogram(y, cfg)
    return torch.sum(torch.abs(y_mag - x_mag)) / torch.sum(torch.abs(y_mag))


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               resolutions: Sequence[Tuple[int, int, int]] = RESOLUTIONS
                               ) -> torch.Tensor:
    """x, y: (B, T) waveforms (prediction, target)."""
    total = 0.0
    for n_fft, hop, win in resolutions:
        total = total + stft_loss(x, y, n_fft, hop, win)
    return total / len(resolutions)
