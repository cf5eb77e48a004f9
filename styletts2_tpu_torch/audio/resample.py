"""Polyphase windowed-sinc resampling (torchaudio ``Resample`` semantics:
Hann window, lowpass filter width 6, rolloff 0.99), the SLM loss's 24 kHz ->
16 kHz step (ref: losses.py:239-247), as one strided convolution.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99):
    """(kernels (new, 2 * width + orig) f32 numpy, width, orig, new), with
    the rates reduced by their gcd."""
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd

    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64) / new)[:, None] + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / orig
    kernels = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * scale
    return kernels.astype(np.float32), width, orig, new


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample (..., T) from ``orig_freq`` to ``new_freq``: ``ceil(new_freq
    * T / orig_freq)`` samples."""
    if orig_freq == new_freq:
        return x
    kernels, width, orig, new = _sinc_kernel(orig_freq, new_freq, lowpass_filter_width,
                                             rolloff)
    length = x.shape[-1]
    lead = x.shape[:-1]
    xx = F.pad(x.reshape(-1, 1, length), (width, width + orig))
    w = torch.from_numpy(kernels).to(device=x.device, dtype=x.dtype)[:, None, :]
    y = F.conv1d(xx, w, stride=orig)                        # (N, new, frames)
    y = y.transpose(1, 2).reshape(*lead, -1)
    return y[..., : int(math.ceil(new_freq * length / orig_freq))]
