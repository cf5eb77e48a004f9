"""Long-form synthesis post-processing
(ref: Colab/StyleTTS2_Demo_LJSpeech-new.ipynb helper cells), on the host in
numpy: a copy of ``styletts2_tpu/audio/postprocess.py``.

Crossfade concatenation of per-sentence chunks, tail trimming, and a simple
spectral-gate denoise matching the Colab demo's noise-estimate/denoise pass.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def crossfade_concat(chunks: Sequence[np.ndarray], sr: int = 24000,
                     fade_ms: float = 20.0) -> np.ndarray:
    """Overlap-add chunks with a raised-cosine crossfade."""
    chunks = [np.asarray(c, np.float32) for c in chunks if len(c)]
    if not chunks:
        return np.zeros(0, np.float32)
    n_fade = int(sr * fade_ms / 1000.0)
    out = chunks[0]
    for nxt in chunks[1:]:
        n = min(n_fade, len(out), len(nxt))
        if n == 0:
            out = np.concatenate([out, nxt])
            continue
        t = np.linspace(0, np.pi, n, dtype=np.float32)
        fade_out = 0.5 * (1 + np.cos(t))
        fade_in = 1.0 - fade_out
        merged = out[-n:] * fade_out + nxt[:n] * fade_in
        out = np.concatenate([out[:-n], merged, nxt[n:]])
    return out


def trim_tail(wave: np.ndarray, samples: int = 50) -> np.ndarray:
    """Drop trailing click samples (the reference trims 50-100 samples,
    Demo/Inference_LibriTTS.ipynb cell 16)."""
    return wave[:-samples] if samples and len(wave) > samples else wave


def spectral_gate_denoise(wave: np.ndarray, sr: int = 24000,
                          n_fft: int = 1024, hop: int = 256,
                          noise_frames: int = 10,
                          reduction: float = 0.8) -> np.ndarray:
    """Lightweight spectral gating: estimate the noise floor from the first
    frames and attenuate bins below it (the Colab demo applies a similar
    noisereduce pass)."""
    wave = np.asarray(wave, np.float32)
    if len(wave) < n_fft * 2:
        return wave
    window = np.hanning(n_fft).astype(np.float32)
    frames = 1 + (len(wave) - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(wave[idx] * window, axis=1)
    mag = np.abs(spec)
    noise_floor = mag[:noise_frames].mean(axis=0, keepdims=True) * 1.5
    gain = np.clip((mag - reduction * noise_floor) / np.maximum(mag, 1e-9), 0.0, 1.0)
    spec = spec * gain
    rec = np.fft.irfft(spec, n=n_fft, axis=1) * window
    out = np.zeros(len(wave), np.float32)
    norm = np.zeros(len(wave), np.float32)
    for t in range(frames):
        out[t * hop: t * hop + n_fft] += rec[t]
        norm[t * hop: t * hop + n_fft] += window ** 2
    return out / np.maximum(norm, 1e-8)
