"""Validation steps (the port of ``styletts2_tpu/train/validate.py``; ref:
train_first.py:457-545, train_second.py:949-1068).

Stage 1: the mel reconstruction loss with the ground-truth alignment, F0 and
energy: the aligner and the monotonic path (kernel K3), the text encoder,
one clip per sample, the pitch extractor, the style encoder, the decoder
(iSTFTNet or HiFi-GAN, its AdaIN -> Snake pairs through kernel K1f) and the
multi-resolution STFT loss.  Stage 2 adds the duration L1 of the prosody predictor against the
monotonic path, and its F0 and energy drive the decoder (with the F0 loss
against the pitch extractor's).  All in eval form (no dropout, no dither,
no smoothing), masked as the training steps are.  The clip starts are an
explicit input, as every stochastic input of the port is.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from ..config import Config
from ..losses.stft_loss import multi_resolution_stft_loss
from ..models.decoder import decoder_apply
from ..models.jdc import jdc_apply
from ..models.plbert import plbert_apply
from ..models.predictor import prosody_duration_apply, prosody_f0n_apply
from ..models.style_encoder import style_encoder_apply
from ..models.text_encoder import text_encoder_apply
from ..nn.linear import linear
from .stage1 import HOP, clip_batch, clip_starts, compute_alignment
from .stage2 import _smooth_l1, duration_losses


def make_stage1_val_step(config: Config, configs: Dict, mel_len: int):
    """``val_step(nets, batch, clip_u) -> {"mel_loss": 0-dim tensor}`` for
    clips of ``mel_len`` aligner frames.  batch: ``waves`` (B, T_wav) f32,
    ``mel_input_length``, ``texts``, ``input_lengths`` on the nets' device;
    clip_u (B,) uniforms in [0, 1): the starts ``floor(u * max(half_len -
    mel_len, 1))``."""

    @torch.no_grad()
    def val_step(nets: nn.ModuleDict, batch: Dict[str, torch.Tensor],
                 clip_u: torch.Tensor) -> Dict[str, torch.Tensor]:
        waves = batch["waves"]
        mels = log_mel_spectrogram(waves, DATASET_MEL)
        mels = mels[..., : (mels.shape[-1] // 2) * 2]
        mel_lengths = batch["mel_input_length"]
        texts, text_lengths = batch["texts"], batch["input_lengths"]

        *_, mono = compute_alignment(nets["text_aligner"], mels, mel_lengths, texts,
                                     text_lengths)
        asr = text_encoder_apply(nets["text_encoder"], texts, text_lengths) @ mono

        starts = clip_starts(clip_u, mel_lengths // 2, mel_len)
        en = clip_batch(asr, starts, mel_len)
        gt = clip_batch(mels, starts * 2, mel_len * 2)
        wav = clip_batch(waves, starts * 2 * HOP, mel_len * 2 * HOP)

        f0, _, _ = jdc_apply(nets["pitch_extractor"], gt[:, None])
        s = style_encoder_apply(nets["style_encoder"], gt[:, None])
        y_rec = decoder_apply(nets["decoder"], en, f0, log_norm(gt), s)
        return {"mel_loss": multi_resolution_stft_loss(y_rec[:, 0, :].float(), wav.float())}

    return val_step


def make_stage2_val_step(config: Config, configs: Dict, mel_len: int):
    """``val_step(nets, batch, clip_u) -> {"mel_loss", "dur_loss",
    "F0_loss"}`` (0-dim tensors) for clips of ``mel_len`` aligner frames;
    the arguments as ``make_stage1_val_step``'s."""

    @torch.no_grad()
    def val_step(nets: nn.ModuleDict, batch: Dict[str, torch.Tensor],
                 clip_u: torch.Tensor) -> Dict[str, torch.Tensor]:
        waves = batch["waves"]
        mels = log_mel_spectrogram(waves, DATASET_MEL)
        mels = mels[..., : (mels.shape[-1] // 2) * 2]
        mel_lengths = batch["mel_input_length"]
        texts, text_lengths = batch["texts"], batch["input_lengths"]

        *_, mono = compute_alignment(nets["text_aligner"], mels, mel_lengths, texts,
                                     text_lengths)
        asr = text_encoder_apply(nets["text_encoder"], texts, text_lengths) @ mono
        s_dur = style_encoder_apply(nets["predictor_encoder"], mels[:, None], mel_lengths)
        text_keep = (torch.arange(texts.shape[1], device=texts.device)[None, :]
                     < text_lengths[:, None])
        bert_dur = plbert_apply(nets["bert"], texts, text_keep.to(torch.int32))
        be = nets["bert_encoder"]
        d_en = linear(bert_dur, be.weight, be.bias).transpose(1, 2)
        dur_logits, p_full = prosody_duration_apply(nets["predictor"], d_en, s_dur,
                                                    text_lengths, mono)
        _, loss_dur = duration_losses(dur_logits, mono.sum(-1), text_lengths)

        starts = clip_starts(clip_u, mel_lengths // 2, mel_len)
        en = clip_batch(asr, starts, mel_len)
        p_en = clip_batch(p_full, starts, mel_len)
        gt = clip_batch(mels, starts * 2, mel_len * 2)
        wav = clip_batch(waves, starts * 2 * HOP, mel_len * 2 * HOP)

        s_clip = style_encoder_apply(nets["style_encoder"], gt[:, None])
        s_dur_clip = style_encoder_apply(nets["predictor_encoder"], gt[:, None])
        f0_real, _, _ = jdc_apply(nets["pitch_extractor"], gt[:, None])
        f0_fake, n_fake = prosody_f0n_apply(nets["predictor"], p_en, s_dur_clip)
        y_rec = decoder_apply(nets["decoder"], en, f0_fake, n_fake, s_clip)
        return {"mel_loss": multi_resolution_stft_loss(y_rec[:, 0, :].float(), wav.float()),
                "dur_loss": loss_dur, "F0_loss": _smooth_l1(f0_real, f0_fake) / 10.0}

    return val_step
