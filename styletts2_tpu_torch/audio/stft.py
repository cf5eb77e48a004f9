"""STFT magnitude/phase and its inverse for the iSTFTNet head and its
harmonic source (ref: Modules/istftnet.py:83-109), as ``torch.stft`` and
``torch.istft``: centered frames, reflect padding, periodic Hann window.
"""

from __future__ import annotations

import torch


def _window(win_length: int, x: torch.Tensor) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                             device=x.device)


def stft_mag_phase(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int):
    """x (B, T) -> (magnitude, phase), each (B, n_fft//2 + 1, n_frames).

    Imaginary parts that are exactly zero take the +0.0 sign before
    ``atan2``: ``atan2(+0.0, -x) = +pi`` while ``atan2(-0.0, -x) = -pi``, a
    2*pi jump in the conv inputs downstream.  Frame 0 sits on that branch cut.
    """
    spec = torch.stft(x.float(), n_fft, hop_length, win_length,
                      window=_window(win_length, x), center=True,
                      pad_mode="reflect", return_complex=True)
    im = spec.imag
    im = torch.where(im == 0.0, torch.zeros_like(im), im)
    return spec.abs(), torch.atan2(im, spec.real)


def istft_from_mag_phase(mag: torch.Tensor, phase: torch.Tensor, n_fft: int,
                         hop_length: int, win_length: int) -> torch.Tensor:
    """Inverse of :func:`stft_mag_phase`: (B, n_bins, n_frames) pair ->
    (B, hop * (n_frames - 1)) with the center padding trimmed."""
    spec = torch.polar(mag.float(), phase.float())
    return torch.istft(spec, n_fft, hop_length, win_length,
                       window=_window(win_length, mag), center=True)
