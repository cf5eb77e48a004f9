"""The SLM (Whisper) feature loss of stage 1's TMA phase (ref:
losses.py:195-319).

Both waveforms go to 16 kHz, through the Whisper log-mel and the frozen
encoder; every hidden state is linearly interpolated to the StyleTTS2 frame
count, and the loss is the mean L1 between the real and generated states,
averaged over the states.  The real side runs with no graph.  The stage-2
SLM adversarial losses (``slm_generator_loss``, ``slm_discriminator_loss``)
are not ported yet.
"""

from __future__ import annotations

import math
from typing import List

import torch

from ..audio.resample import resample
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
