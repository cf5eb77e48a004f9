"""The SLM (Whisper) losses (ref: losses.py:195-353).

Waveforms go to 16 kHz, through the Whisper log-mel and the frozen encoder;
every hidden state is linearly interpolated to the StyleTTS2 frame count.
- ``slm_feature_loss`` (stage 1's TMA phase, stage 2): the mean L1 between
  the real and generated states, averaged over the states; the real side
  runs with no graph.
- stage 2's adversarial losses on the Whisper discriminator (WD) over the
  stacked states (B, layers * d_model, T): ``slm_generator_loss`` (LSGAN,
  gradients through the encoder to the waveform), ``slm_discriminator_loss``
  and ``slm_discriminator_forward`` (the encoder with no graph, gradients to
  the WD only).  Per-sample means are averaged with optional sample weights,
  the masked validity of the SLM adversarial step.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..audio.resample import resample
from ..models.discriminators import WhisperDiscriminator, whisper_discriminator_apply
from ..models.whisper import WhisperEncoder, whisper_encoder_apply, whisper_log_mel
from ..nn.conv import interpolate_linear


def slm_encode(encoder: WhisperEncoder, audio: torch.Tensor, target_length: int,
               model_sr: int = 24000) -> List[torch.Tensor]:
    """audio (B, T) at ``model_sr`` -> the encoder's hidden states, each
    interpolated to (B, target_length, d_model) (ref: losses.py:270-307).
    The log-mel is zero-padded or cut to an even frame count of at most
    twice the encoder's positions."""
    cfg = encoder.cfg
    log_mel = whisper_log_mel(resample(audio, model_sr, cfg.sample_rate), cfg)
    seq = log_mel.shape[-1]
    padded = min(int(math.ceil(seq / 2) * 2), cfg.max_source_positions * 2)
    if seq > padded:
        log_mel = log_mel[..., :padded]
    elif seq < padded:
        log_mel = torch.nn.functional.pad(log_mel, (0, padded - seq))
    return [interpolate_linear(hs.transpose(1, 2), target_length).transpose(1, 2)
            for hs in whisper_encoder_apply(encoder, log_mel)]


def target_frames(num_samples: int, hop_length: int = 300) -> int:
    return max(1, int(math.ceil(num_samples / hop_length)))


def slm_feature_loss(encoder: WhisperEncoder, wav: torch.Tensor, y_rec: torch.Tensor,
                     hop_length: int = 300) -> torch.Tensor:
    """Mean L1 between the real and generated hidden states, over the
    states (ref: losses.py:309-319); wav, y_rec (B, T)."""
    t = max(target_frames(wav.shape[-1], hop_length), target_frames(y_rec.shape[-1], hop_length))
    with torch.no_grad():
        real_states = slm_encode(encoder, wav, t)
    gen_states = slm_encode(encoder, y_rec, t)
    loss = 0.0
    for real, gen in zip(real_states, gen_states):
        loss = loss + torch.mean(torch.abs(real - gen), dtype=torch.float32)
    return loss / len(real_states)


def slm_features(encoder: WhisperEncoder, audio: torch.Tensor, target_length: int
                 ) -> torch.Tensor:
    """The hidden states of ``slm_encode`` stacked channels-first:
    (B, layers * d_model, target_length)."""
    return torch.cat([h.transpose(1, 2) for h in slm_encode(encoder, audio, target_length)],
                     dim=1)


def weighted_mean(per_sample: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over samples, weighted when ``weights`` (B,) is given:
    ``sum(x w) / max(sum(w), 1)``."""
    if weights is None:
        return torch.mean(per_sample)
    w = weights.to(per_sample.dtype)
    return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)


def slm_generator_loss(encoder: WhisperEncoder, wd: WhisperDiscriminator, y_rec: torch.Tensor,
                       hop_length: int = 300, sample_weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """LSGAN generator loss ``(1 - D(y_rec))^2`` per sample, y_rec (B, T)."""
    emb = slm_features(encoder, y_rec, target_frames(y_rec.shape[-1], hop_length))
    score = whisper_discriminator_apply(wd, emb)
    return weighted_mean(torch.mean((1.0 - score) ** 2, dim=-1), sample_weights)


def slm_discriminator_loss(encoder: WhisperEncoder, wd: WhisperDiscriminator,
                           wav: torch.Tensor, y_rec: torch.Tensor, hop_length: int = 300,
                           sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LSGAN discriminator loss on real ``wav`` and generated ``y_rec``
    (B, T each), both encoded with no graph at the larger of their frame
    counts."""
    t = max(target_frames(wav.shape[-1], hop_length), target_frames(y_rec.shape[-1], hop_length))
    with torch.no_grad():
        emb_r = slm_features(encoder, wav, t)
        emb_g = slm_features(encoder, y_rec, t)
    score_r = whisper_discriminator_apply(wd, emb_r)
    score_g = whisper_discriminator_apply(wd, emb_g)
    return (weighted_mean(torch.mean((1.0 - score_r) ** 2, dim=-1), sample_weights)
            + weighted_mean(torch.mean(score_g ** 2, dim=-1), sample_weights))


def slm_discriminator_forward(encoder: WhisperEncoder, wd: WhisperDiscriminator,
                              wav: torch.Tensor, hop_length: int = 300) -> torch.Tensor:
    """The WD's scores (B, frames) of ``wav`` (B, T), encoded with no graph."""
    with torch.no_grad():
        emb = slm_features(encoder, wav, target_frames(wav.shape[-1], hop_length))
    return whisper_discriminator_apply(wd, emb)
