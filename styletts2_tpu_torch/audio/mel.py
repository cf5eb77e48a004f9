"""Mel-spectrogram frontends (the port of ``styletts2_tpu/audio/mel.py``).

Two configurations, both kept:

1. the *dataset* frontend (ref: meldataset.py:35-43): n_fft 2048, win 1200,
   hop 300, 80 mels, with the filterbank laid out at torchaudio's default
   16 kHz although the audio is 24 kHz, so it spans 0..8 kHz.  Every
   published checkpoint was trained with this quirk; it is the default;
2. the *loss* frontends (ref: losses.py:26-57) at ``sample_rate=24000`` with
   several (n_fft, hop, win) resolutions.

Both normalize as ``(log(1e-5 + mel) - (-4)) / 4``.  The STFT is
``torch.stft``: centred frames, reflect padding, a periodic Hann window of
``win_length`` centred in ``n_fft``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


def _hz_to_mel_htk(freq):
    return 2595.0 * np.log10(1.0 + freq / 700.0)


def _mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def _fbanks_np(n_freqs: int, f_min: float, f_max: float, n_mels: int,
               sample_rate: int) -> np.ndarray:
    # triangular HTK-scale filters, no normalization: torchaudio's
    # melscale_fbanks(norm=None, mel_scale="htk")
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]            # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int, device=None) -> torch.Tensor:
    """(n_freqs, n_mels) HTK-scale triangular filterbank."""
    fb = _fbanks_np(n_freqs, float(f_min), float(f_max), n_mels, sample_rate)
    return torch.from_numpy(fb).to(device)


@dataclasses.dataclass(frozen=True)
class LogMelConfig:
    n_fft: int = 2048
    win_length: int = 1200
    hop_length: int = 300
    n_mels: int = 80
    # the filterbank's rate: 16000 reproduces the dataset quirk
    fbank_sample_rate: int = 16000
    f_min: float = 0.0
    f_max: Optional[float] = None
    mean: float = -4.0
    std: float = 4.0
    power: float = 2.0

    @property
    def effective_f_max(self) -> float:
        return self.f_max if self.f_max is not None else float(self.fbank_sample_rate) / 2.0


DATASET_MEL = LogMelConfig()
LOSS_MEL_24K = LogMelConfig(fbank_sample_rate=24000)


def mel_spectrogram(wave: torch.Tensor, cfg: LogMelConfig = DATASET_MEL) -> torch.Tensor:
    """Power mel spectrogram of ``wave`` (..., T) -> (..., n_mels, n_frames)."""
    lead = wave.shape[:-1]
    window = torch.hann_window(cfg.win_length, periodic=True, dtype=torch.float32,
                               device=wave.device)
    spec = torch.stft(wave.reshape(-1, wave.shape[-1]).float(), cfg.n_fft, cfg.hop_length,
                      cfg.win_length, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    if cfg.power == 2.0:
        power = spec.real * spec.real + spec.imag * spec.imag
    else:
        power = spec.abs() ** cfg.power
    fb = melscale_fbanks(cfg.n_fft // 2 + 1, cfg.f_min, cfg.effective_f_max, cfg.n_mels,
                         cfg.fbank_sample_rate, wave.device)
    mel = (power.transpose(-1, -2) @ fb).transpose(-1, -2)
    return mel.reshape(*lead, *mel.shape[-2:])


def log_mel_spectrogram(wave: torch.Tensor, cfg: LogMelConfig = DATASET_MEL) -> torch.Tensor:
    """Normalized log-mel: ``(log(1e-5 + mel) - mean) / std``."""
    return (torch.log(1e-5 + mel_spectrogram(wave, cfg)) - cfg.mean) / cfg.std


def log_norm(x: torch.Tensor, mean: float = -4.0, std: float = 4.0,
             axis: int = -2) -> torch.Tensor:
    """log L2-norm over the mel axis of the de-normalized mel: the energy
    target (ref: utils.py:45-50); (..., n_mels, frames) -> (..., frames)."""
    return torch.log(torch.linalg.vector_norm(torch.exp(x * std + mean), dim=axis))
