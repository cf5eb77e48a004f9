"""The Whisper encoder, the frozen SLM feature extractor of stage 1's TMA
phase (ref: losses.py:195-353, HF ``WhisperModel.encoder`` of
openai/whisper-base), and its Slaney log-mel frontend.

The conv stem, the learned positions cropped to the clip length (ref:
losses.py:283-293), six pre-LN layers, and every hidden state (the stem's
output and each layer's) for the SLM feature loss, the last one replaced by
the final layer norm's output as HF does.  The log-mel is
``log10(max(mel, 1e-10))`` with no dynamic-range compression and every
frame kept (ref: losses.py:252-268), as the JAX package computes it, not
HF's feature extractor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch
from torch import nn

from ..nn.activations import gelu
from ..nn.conv import conv1d
from ..nn.linear import linear
from ..nn.norm import layer_norm


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 512
    num_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    max_source_positions: int = 1500
    n_fft: int = 400
    hop_length: int = 160
    sample_rate: int = 16000


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
                    3.0 * f / 200.0)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), 200.0 * m / 3.0)


@functools.lru_cache(maxsize=None)
def slaney_fbanks(n_freqs: int = 201, n_mels: int = 80, f_min: float = 0.0,
                  f_max: float = 8000.0, sample_rate: int = 16000) -> np.ndarray:
    """(n_freqs, n_mels) Slaney-scale, Slaney-normalised filterbank."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb = fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    return fb.astype(np.float32)


def whisper_log_mel(audio16k: torch.Tensor, cfg: WhisperConfig = WhisperConfig()
                    ) -> torch.Tensor:
    """(B, T) at 16 kHz -> (B, n_mels, T // hop + 1): the power spectrum of
    the centred, reflect-padded STFT (periodic Hann) through the Slaney
    filterbank, ``log10`` with a 1e-10 floor."""
    window = torch.hann_window(cfg.n_fft, periodic=True, dtype=torch.float32,
                               device=audio16k.device)
    spec = torch.stft(audio16k.float(), cfg.n_fft, cfg.hop_length, cfg.n_fft, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    mag2 = spec.real ** 2 + spec.imag ** 2                     # (B, F, T)
    fb = torch.from_numpy(slaney_fbanks(cfg.n_fft // 2 + 1, cfg.n_mels)).to(audio16k.device)
    mel = torch.matmul(mag2.transpose(1, 2), fb).transpose(1, 2)
    return torch.log10(torch.clamp(mel, min=1e-10))


class _WhisperLayer(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.self_attn = nn.ModuleDict({
            "q_proj": nn.Linear(d, d), "k_proj": nn.Linear(d, d, bias=False),
            "v_proj": nn.Linear(d, d), "out_proj": nn.Linear(d, d)})
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.final_layer_norm = nn.LayerNorm(d)


class WhisperEncoder(nn.Module):
    """HF ``WhisperEncoder`` parameters (``state_dict`` keys as the JAX
    package's ``init_whisper_encoder`` tree)."""

    def __init__(self, cfg: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3)
        self.conv2 = nn.Conv1d(d, d, 3)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, d)
        self.layers = nn.ModuleList(_WhisperLayer(d, cfg.ffn_dim) for _ in range(cfg.num_layers))
        self.layer_norm = nn.LayerNorm(d)


def _lin(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    return linear(x, m.weight, m.bias)


def _ln(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return layer_norm(x, m.weight, m.bias)


def whisper_encoder_apply(m: WhisperEncoder, log_mel: torch.Tensor) -> List[torch.Tensor]:
    """log_mel (B, n_mels, frames) -> ``num_layers + 1`` hidden states, each
    (B, frames // 2, d_model): the stem's output, then each layer's, the
    last one through the final layer norm."""
    h = gelu(conv1d(log_mel, m.conv1.weight, m.conv1.bias, padding=1))
    h = gelu(conv1d(h, m.conv2.weight, m.conv2.bias, stride=2, padding=1))
    h = h.transpose(1, 2)                                      # (B, T, D)
    h = h + m.embed_positions.weight[: h.shape[1]][None]
    states = [h]
    for layer in m.layers:
        h = _whisper_layer(layer, h, m.cfg.num_heads)
        states.append(h)
    states[-1] = _ln(h, m.layer_norm)
    return states


def _whisper_layer(p: _WhisperLayer, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = h.shape
    hd = d // n_heads
    a = p.self_attn

    def heads(z):
        return z.reshape(b, t, n_heads, hd).transpose(1, 2)

    x = _ln(h, p.self_attn_layer_norm)
    q = _lin(x, a["q_proj"]) * (hd ** -0.5)
    k = _lin(x, a["k_proj"])
    v = _lin(x, a["v_proj"])
    attn = torch.softmax(torch.matmul(heads(q), heads(k).transpose(-1, -2)), dim=-1)
    ctx = torch.matmul(attn, heads(v)).transpose(1, 2).reshape(b, t, d)
    h = h + _lin(ctx, a["out_proj"])
    x = gelu(_lin(_ln(h, p.final_layer_norm), p.fc1))
    return h + _lin(x, p.fc2)
