"""Stage-1 training before TMA: mel reconstruction (ref: train_first.py:104-576;
the JAX package's ``train/stage1.py``, ``tma=False``).

One step: the log-mel of the batch's waveforms on the device, cut to an even
length; the frozen aligner (with its dropout) and the monotonic path (kernel
K3) under ``no_grad``; the text encoder; the soft or the monotonic alignment,
one draw for the whole batch; a random clip per sample; the frozen pitch
extractor on the clip; the style encoder; the training decoder (its 48
AdaIN -> Snake pairs through kernels K1f/K1b); and the multi-resolution STFT
loss, alone (the reference leaves ``lambda_mel`` out of the pre-TMA loss).
AdamW then updates the text encoder, style encoder and decoder.

Every random input of the step is an explicit tensor of ``Stage1Noise``,
drawn in one place from a ``torch.Generator`` on the step's device, so the
tests can feed the draws the JAX package makes.  The TMA phase (MPD/MSD, the
GAN and SLM losses, the discriminator step) is the next slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from ..config import Config, ModelParams
from ..losses.stft_loss import multi_resolution_stft_loss
from ..models.asr import ASRNoise, asr_apply
from ..models.decoder.istftnet import F0_SMOOTH, N_SMOOTH, decoder_apply
from ..models.jdc import jdc_apply
from ..models.style_encoder import style_encoder_apply
from ..models.text_encoder import DROPOUT as TEXT_DROPOUT
from ..models.text_encoder import text_encoder_apply
from ..ops.monotonic import maximum_path
from .optimizers import MultiOptimizer

HOP = 300
N_DOWN = 1          # the aligner's time downsampling (ref: Utils/ASR/models.py n_down=1)
TRAINED = ("text_encoder", "style_encoder", "decoder")


@dataclasses.dataclass
class Stage1Noise:
    """The random inputs of one pre-TMA step.

    asr: the aligner's dropout masks and token masking; text_keep (depth, B,
    C, T_text) bool: the text encoder's dropout (None: off); use_mono 0-dim
    bool: the monotonic path instead of the soft alignment, for the whole
    batch; clip_u, style_clip_u (B,) uniforms in [0, 1): the clip starts
    ``floor(u * max(half_len - mel_len, 1))``; f0_smooth, n_smooth 0-dim
    int: indices into the decoder's ``F0_SMOOTH`` and ``N_SMOOTH``;
    source_noise (B, harmonics, T_audio) standard normals: the harmonic
    source's dither.
    """

    asr: ASRNoise
    text_keep: Optional[torch.Tensor]
    use_mono: torch.Tensor
    clip_u: torch.Tensor
    style_clip_u: torch.Tensor
    f0_smooth: torch.Tensor
    n_smooth: torch.Tensor
    source_noise: torch.Tensor

    @classmethod
    def draw(cls, generator: torch.Generator, nets: nn.ModuleDict,
             batch: Dict[str, torch.Tensor], mel_len: int) -> "Stage1Noise":
        """Every draw of one step from ``generator``, on the batch's device;
        the shapes follow ``nets`` and the batch."""
        texts = batch["texts"]
        dev = texts.device
        b, t_text = texts.shape
        t_mel = (_n_frames(batch["waves"].shape[-1]) // 2) * 2
        te, gen = nets["text_encoder"], nets["decoder"].generator
        harmonics = gen.m_source.l_linear.weight.shape[1]
        samples_per_frame = math.prod(gen.cfg.upsample_rates) * gen.cfg.gen_istft_hop_size

        def u(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        def pick(n):
            return torch.randint(0, n, (), generator=generator, device=dev)

        return cls(
            asr=ASRNoise.draw(generator, nets["text_aligner"].cfg, b, t_text, t_mel // 2, dev),
            text_keep=u(len(te.cnn), b, te.embedding.embedding_dim, t_text) < 1.0 - TEXT_DROPOUT,
            use_mono=u() < 0.5,
            clip_u=u(b), style_clip_u=u(b),
            f0_smooth=pick(len(F0_SMOOTH)), n_smooth=pick(len(N_SMOOTH)),
            source_noise=torch.randn((b, harmonics, mel_len * 2 * samples_per_frame),
                                     generator=generator, device=dev))


def _n_frames(n_samples: int) -> int:
    """Frames of the centred dataset STFT of ``n_samples`` samples."""
    return n_samples // DATASET_MEL.hop_length + 1


def clip_batch(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """Per-sample crops of ``length`` along the last axis, each start clamped
    into the array as ``lax.dynamic_slice`` does."""
    size = x.shape[-1]
    starts = torch.clamp(starts, 0, max(size - length, 0))
    idx = starts[:, None] + torch.arange(length, device=x.device)[None, :]
    idx = idx.reshape(idx.shape[0], *([1] * (x.dim() - 2)), length)
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], length))


def clip_starts(u: torch.Tensor, half_len: torch.Tensor, mel_len: int) -> torch.Tensor:
    """``floor(u * max(half_len - mel_len, 1))`` in f32, per sample."""
    span = torch.clamp(half_len - mel_len, min=1).to(torch.float32)
    return (u * span).to(torch.int64)


@torch.no_grad()
def compute_alignment(aligner: nn.Module, mels: torch.Tensor, mel_lengths: torch.Tensor,
                      texts: torch.Tensor, text_lengths: torch.Tensor,
                      noise: Optional[ASRNoise] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The aligner forward and the monotonic path (ref: train_first.py:317-345):
    (ppgs, s2s_pred, s2s_attn (B, T_text, T_mel//2), s2s_attn_mono).

    Under ``no_grad``: before TMA the aligner is frozen, and the path is a
    constant on both sides (ref: utils.py:11-24)."""
    b, _, t_mel = mels.shape
    t_text = texts.shape[1]
    dev = mels.device
    mel_len_down = mel_lengths // (2 ** N_DOWN)
    frames = torch.arange(t_mel // 2, device=dev)[None, :]
    mem_mask = frames + 1 > mel_len_down[:, None]
    out = asr_apply(aligner, mels, mem_mask, texts, noise)
    s2s_attn = out["s2s_attn"][:, 1:, :]                       # drop the SOS step
    text_keep = torch.arange(t_text, device=dev)[None, :] + 1 <= text_lengths[:, None]
    mel_keep = frames + 1 <= mel_len_down[:, None]
    s2s_attn = s2s_attn * (text_keep[:, :, None] & mel_keep[:, None, :])
    mono = maximum_path(s2s_attn, text_lengths, mel_len_down)
    return out["ctc_logits"], out["s2s_logits"], s2s_attn, mono


def stage1_loss(nets: nn.ModuleDict, mp: ModelParams, batch: Dict[str, torch.Tensor],
                noise: Stage1Noise, mel_len: int, mel_len_st: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The pre-TMA generator loss of one batch: ``(loss_mel, aux)``, with
    gradients to the text encoder, style encoder and decoder (``aux["y_rec"]``,
    the decoder's waveform, carries them too).

    batch: ``waves`` (B, T_wav) f32, ``mel_input_length`` (B,), ``texts``
    (B, T_text) int64, ``input_lengths`` (B,); ``mel_len`` the clip length
    in aligner frames (mel frames // 2)."""
    waves = batch["waves"]
    mels = log_mel_spectrogram(waves, DATASET_MEL)
    mels = mels[..., : (mels.shape[-1] // 2) * 2]
    mel_lengths = batch["mel_input_length"]
    texts, text_lengths = batch["texts"], batch["input_lengths"]

    _, s2s_pred, s2s_attn, s2s_attn_mono = compute_alignment(
        nets["text_aligner"], mels, mel_lengths, texts, text_lengths, noise.asr)
    t_en = text_encoder_apply(nets["text_encoder"], texts, text_lengths, noise.text_keep)
    attn = torch.where(noise.use_mono, s2s_attn_mono, s2s_attn)
    asr_feats = t_en @ attn                                    # (B, C, T_mel//2)

    half_len = mel_lengths // 2
    starts = clip_starts(noise.clip_u, half_len, mel_len)
    en = clip_batch(asr_feats, starts, mel_len)
    gt = clip_batch(mels, starts * 2, mel_len * 2)
    wav = clip_batch(waves, starts * 2 * HOP, mel_len * 2 * HOP)
    st_starts = clip_starts(noise.style_clip_u, half_len, mel_len_st)
    st = clip_batch(mels, st_starts * 2, mel_len_st * 2)

    with torch.no_grad():
        real_norm = log_norm(gt)
        f0_real, _, _ = jdc_apply(nets["pitch_extractor"], gt[:, None])
    s = style_encoder_apply(nets["style_encoder"], (st if mp.multispeaker else gt)[:, None])
    y_rec = decoder_apply(nets["decoder"], en, f0_real, real_norm, s,
                          source_noise=noise.source_noise,
                          smooth=(noise.f0_smooth, noise.n_smooth))
    loss_mel = multi_resolution_stft_loss(y_rec[:, 0, :].float(), wav.float())
    return loss_mel, {"mel_loss": loss_mel.detach(), "y_rec": y_rec, "wav": wav,
                      "s2s_pred": s2s_pred, "s2s_attn": s2s_attn,
                      "s2s_attn_mono": s2s_attn_mono}


@dataclasses.dataclass
class Stage1Trainer:
    config: Config
    configs: Dict                   # {"model": ModelParams}
    nets: nn.ModuleDict
    optimizer: MultiOptimizer

    def make_step(self, tma: bool, mel_len: int, mel_len_st: int):
        """The step of a (phase, clip length) bucket:
        ``step(batch, noise=None, generator=None) -> metrics``."""
        if tma:
            raise NotImplementedError(
                "the stage-1 TMA phase (MPD/MSD, GAN and SLM losses, the discriminator "
                "step) is the next slice of the port")

        def step(batch, noise: Optional[Stage1Noise] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
            return self.step(batch, mel_len, mel_len_st, noise, generator)
        return step

    def step(self, batch: Dict[str, torch.Tensor], mel_len: int, mel_len_st: int,
             noise: Optional[Stage1Noise] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One pre-TMA step; ``noise`` drawn from ``generator`` when None.
        Returns detached metrics (``mel_loss``, ``g_loss``) on the device."""
        mp: ModelParams = self.configs["model"]
        if noise is None:
            noise = Stage1Noise.draw(generator, self.nets, batch, mel_len)
        self.optimizer.zero_grad(TRAINED)
        loss, aux = stage1_loss(self.nets, mp, batch, noise, mel_len, mel_len_st)
        loss.backward()
        self.optimizer.step(TRAINED)
        return {"mel_loss": aux["mel_loss"], "g_loss": loss.detach()}
