"""Stage-1 validation (the port of ``styletts2_tpu/train/validate.py``'s
``make_stage1_val_step``; ref: train_first.py:457-545).

The mel reconstruction loss with the ground-truth alignment, F0 and energy:
the aligner and the monotonic path (kernel K3), the text encoder, one clip
per sample, the pitch extractor, the style encoder, the decoder (its AdaIN
-> Snake pairs through kernel K1f) and the multi-resolution STFT loss, all
in eval form (no dropout, no dither, no smoothing), masked as the training
step is.  The clip starts are an explicit input, as every stochastic input
of the port is.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from ..config import Config
from ..losses.stft_loss import multi_resolution_stft_loss
from ..models.decoder.istftnet import decoder_apply
from ..models.jdc import jdc_apply
from ..models.style_encoder import style_encoder_apply
from ..models.text_encoder import text_encoder_apply
from .stage1 import HOP, clip_batch, clip_starts, compute_alignment


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
