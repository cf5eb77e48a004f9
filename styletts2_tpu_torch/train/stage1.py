"""Stage-1 training: mel reconstruction, then from ``TMA_epoch`` on the joint
aligner training with the adversarial and SLM losses (ref:
train_first.py:104-576; the JAX package's ``train/stage1.py``).

The forward of one step: the log-mel of the batch's waveforms on the device,
cut to an even length; the aligner (with its dropout) and the monotonic path
(kernel K3, a constant); the text encoder; the soft or the monotonic
alignment, one draw for the whole batch; a random clip per sample; the pitch
extractor on the clip; the style encoder, on the clip or, for a
multispeaker model, on a second random clip of the same utterance; the
training decoder, iSTFTNet or HiFi-GAN (its 48 or 96 AdaIN -> Snake pairs
through kernels K1f/K1b); and the multi-resolution STFT loss.

Before TMA the aligner and the pitch extractor are frozen and run with no
graph, the loss is the STFT loss alone (the reference leaves ``lambda_mel``
out of it), and AdamW updates the text encoder, style encoder and decoder.

With TMA the forward runs once, and then:
1. the discriminator step: the discriminator loss of MPD and MSD on the
   detached waveform, and AdamW on ``mpd`` and ``msd``;
2. the generator step, against the updated discriminators: ``lambda_mel`` x
   mel + ``lambda_mono`` x mono + ``lambda_s2s`` x s2s + ``lambda_gen`` x the
   GAN losses + ``lambda_slm`` x the Whisper feature loss, differentiated
   only into the generator nets (the discriminators' and the Whisper
   encoder's parameters take no gradient), and AdamW on the text encoder,
   style encoder, decoder, aligner and pitch extractor.
The JAX step writes the forward twice and leaves XLA to merge them; here it
runs once and its graph serves the generator step.

Every random input of the step is an explicit tensor of ``Stage1Noise``,
drawn in one place from a ``torch.Generator`` on the step's device, so the
tests can feed the draws the JAX package makes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from ..config import Config, LossParams, ModelParams
from ..losses.gan import discriminator_loss_full, generator_loss_full
from ..losses.slm import slm_feature_loss
from ..losses.stft_loss import multi_resolution_stft_loss
from ..models.asr import ASRNoise, asr_apply
from ..models.decoder import decoder_apply
from ..models.decoder.istftnet import F0_SMOOTH, N_SMOOTH
from ..models.discriminators import mpd_apply, mpd_towers, msd_apply, msd_towers
from ..models.jdc import jdc_apply
from ..models.style_encoder import style_encoder_apply
from ..models.text_encoder import DROPOUT as TEXT_DROPOUT
from ..models.text_encoder import text_encoder_apply
from ..models.whisper import WhisperConfig
from ..models.zoo import STAGE1_TMA_NETS
from ..ops.monotonic import maximum_path
from .optimizers import MultiOptimizer

HOP = 300
N_DOWN = 1          # the aligner's time downsampling (ref: Utils/ASR/models.py n_down=1)
TRAINED = ("text_encoder", "style_encoder", "decoder")
# from TMA on: the five generator nets, and the discriminators
TMA_TRAINED = TRAINED + ("text_aligner", "pitch_extractor")
DISCRIMINATORS = ("mpd", "msd")


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
        b = texts.shape[0]
        gen = nets["decoder"].generator
        harmonics = gen.m_source.l_linear.weight.shape[1]

        def u(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        def pick(n):
            return torch.randint(0, n, (), generator=generator, device=dev)

        asr, text_keep, use_mono = draw_alignment_noise(generator, nets, batch)
        return cls(
            asr=asr, text_keep=text_keep, use_mono=use_mono,
            clip_u=u(b), style_clip_u=u(b),
            f0_smooth=pick(len(F0_SMOOTH)), n_smooth=pick(len(N_SMOOTH)),
            source_noise=torch.randn((b, harmonics, mel_len * 2 * gen.samples_per_frame),
                                     generator=generator, device=dev))


def draw_alignment_noise(generator: torch.Generator, nets: nn.ModuleDict,
                         batch: Dict[str, torch.Tensor]
                         ) -> Tuple[ASRNoise, torch.Tensor, torch.Tensor]:
    """The draws of a trained alignment, in this order: the aligner's
    dropout and token masking, the text encoder's dropout masks (depth, B,
    C, T_text), and the 0-dim bool choice of the monotonic path over the
    soft alignment for the whole batch."""
    texts = batch["texts"]
    dev = texts.device
    b, t_text = texts.shape
    t_mel = (_n_frames(batch["waves"].shape[-1]) // 2) * 2
    te = nets["text_encoder"]
    asr = ASRNoise.draw(generator, nets["text_aligner"].cfg, b, t_text, t_mel // 2, dev)
    text_keep = (torch.rand((len(te.cnn), b, te.embedding.embedding_dim, t_text),
                            generator=generator, device=dev) < 1.0 - TEXT_DROPOUT)
    use_mono = torch.rand((), generator=generator, device=dev) < 0.5
    return asr, text_keep, use_mono


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


def compute_alignment(aligner: nn.Module, mels: torch.Tensor, mel_lengths: torch.Tensor,
                      texts: torch.Tensor, text_lengths: torch.Tensor,
                      noise: Optional[ASRNoise] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The aligner forward and the monotonic path (ref: train_first.py:317-345):
    (ppgs, s2s_pred, s2s_attn (B, T_text, T_mel//2), s2s_attn_mono).

    Under the caller's grad mode: before TMA the aligner is frozen and runs
    with no graph.  The path is a constant either way (ref: utils.py:11-24)."""
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
                noise: Stage1Noise, mel_len: int, mel_len_st: int, tma: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The forward of one batch to the STFT loss: ``(loss_mel, aux)``, with
    gradients to the text encoder, style encoder and decoder, and with
    ``tma`` to the aligner and the pitch extractor too (``aux["y_rec"]``,
    the decoder's waveform, and the aligner's outputs carry them).

    batch: ``waves`` (B, T_wav) f32, ``mel_input_length`` (B,), ``texts``
    (B, T_text) int64, ``input_lengths`` (B,); ``mel_len`` the clip length
    in aligner frames (mel frames // 2)."""
    waves = batch["waves"]
    mels = log_mel_spectrogram(waves, DATASET_MEL)
    mels = mels[..., : (mels.shape[-1] // 2) * 2]
    mel_lengths = batch["mel_input_length"]
    texts, text_lengths = batch["texts"], batch["input_lengths"]

    # before TMA the aligner and the pitch extractor are frozen: no graph
    train_aux = tma and torch.is_grad_enabled()
    with torch.set_grad_enabled(train_aux):
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

    real_norm = log_norm(gt)
    with torch.set_grad_enabled(train_aux):
        f0_real, _, _ = jdc_apply(nets["pitch_extractor"], gt[:, None])
    s = style_encoder_apply(nets["style_encoder"], (st if mp.multispeaker else gt)[:, None])
    y_rec = decoder_apply(nets["decoder"], en, f0_real, real_norm, s,
                          source_noise=noise.source_noise,
                          smooth=(noise.f0_smooth, noise.n_smooth))
    loss_mel = multi_resolution_stft_loss(y_rec[:, 0, :].float(), wav.float())
    return loss_mel, {"mel_loss": loss_mel.detach(), "y_rec": y_rec, "wav": wav,
                      "s2s_pred": s2s_pred, "s2s_attn": s2s_attn,
                      "s2s_attn_mono": s2s_attn_mono, "texts": texts,
                      "text_lengths": text_lengths}


def s2s_loss(s2s_pred: torch.Tensor, texts: torch.Tensor, text_lengths: torch.Tensor
             ) -> torch.Tensor:
    """The aligner's masked per-token cross-entropy (ref:
    train_first.py:407-411) over ``s2s_pred[:, :-1]`` in f32: each sample's
    mean over its length, then the batch mean."""
    logits = s2s_pred[:, :-1, :].float()
    tmask = (torch.arange(logits.shape[1], device=logits.device)[None, :]
             < text_lengths[:, None]).float()
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, texts[..., None])[..., 0]
    return torch.mean((nll * tmask).sum(1) / torch.clamp(tmask.sum(1), min=1.0))


def mono_loss(s2s_attn: torch.Tensor, s2s_attn_mono: torch.Tensor) -> torch.Tensor:
    """``10 * mean|s2s_attn - mono|`` over the whole padded tensor."""
    return torch.mean(torch.abs(s2s_attn - s2s_attn_mono)) * 10.0


def discriminator_step_loss(mpd: nn.Module, msd: nn.Module, wav: torch.Tensor,
                            y_rec: torch.Tensor) -> torch.Tensor:
    """The discriminators' loss on the real wav (B, T) and the generated
    y_rec (B, 1, T), both constants: one 2B pass through each tower."""
    y, y_hat = wav[:, None, :].detach(), y_rec.detach()
    return discriminator_loss_full(mpd_apply(mpd, y, y_hat), msd_apply(msd, y, y_hat))


def generator_adversarial_loss(mpd: nn.Module, msd: nn.Module, wav: torch.Tensor,
                               y_rec: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """``generator_loss_full`` of MPD and MSD, with gradients to y_rec only.

    The real branch is a constant and runs with no graph.  With ``remat``
    the fake branch and the loss run under ``torch.utils.checkpoint``: the
    towers' activations, the largest temporaries of the step, are
    recomputed in the backward instead of held."""
    y = wav[:, None, :].detach()
    with torch.no_grad():
        (mpd_rs, mpd_rf), (msd_rs, msd_rf) = mpd_towers(mpd, y), msd_towers(msd, y)

    def loss(y_hat):
        mpd_gs, mpd_gf = mpd_towers(mpd, y_hat)
        msd_gs, msd_gf = msd_towers(msd, y_hat)
        return generator_loss_full((mpd_rs, mpd_gs, mpd_rf, mpd_gf),
                                   (msd_rs, msd_gs, msd_rf, msd_gf))

    return checkpoint(loss, y_rec, use_reentrant=False) if remat else loss(y_rec)


def tma_generator_loss(nets: nn.ModuleDict, lp: LossParams, loss_mel: torch.Tensor,
                       aux: Dict[str, torch.Tensor], hop_length: int = 300,
                       remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The TMA phase's generator loss from the forward's ``loss_mel`` and
    ``aux`` (ref: train_first.py:395-430): ``(g_loss, metrics)``."""
    wav, y_rec = aux["wav"], aux["y_rec"]
    loss_s2s = s2s_loss(aux["s2s_pred"], aux["texts"], aux["text_lengths"])
    loss_mono = mono_loss(aux["s2s_attn"], aux["s2s_attn_mono"])
    loss_gen = generator_adversarial_loss(nets["mpd"], nets["msd"], wav, y_rec, remat)
    loss_slm = slm_feature_loss(nets["slm_encoder"], wav, y_rec[:, 0, :], hop_length)
    g_loss = (lp.lambda_mel * loss_mel + lp.lambda_mono * loss_mono
              + lp.lambda_s2s * loss_s2s + lp.lambda_gen * loss_gen + lp.lambda_slm * loss_slm)
    return g_loss, {"gen_loss": loss_gen.detach(), "mono_loss": loss_mono.detach(),
                    "s2s_loss": loss_s2s.detach(), "slm_loss": loss_slm.detach()}


@contextlib.contextmanager
def frozen(modules: Iterable[nn.Module]):
    """Parameters of ``modules`` take no gradient inside the block."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


@dataclasses.dataclass
class Stage1Trainer:
    config: Config
    configs: Dict                   # {"model": ModelParams, "whisper": WhisperConfig}
    nets: nn.ModuleDict
    optimizer: MultiOptimizer
    remat_discriminators: bool = True  # recompute the generator side's MPD/MSD
                                       # activations in the backward

    def make_step(self, tma: bool, mel_len: int, mel_len_st: int):
        """The step of a (phase, clip length) bucket:
        ``step(batch, noise=None, generator=None) -> metrics``."""
        if tma:
            missing = [n for n in STAGE1_TMA_NETS if n not in self.nets]
            if missing:
                raise ValueError(f"the TMA phase needs the nets {missing} "
                                 "(models.zoo.STAGE1_TMA_NETS)")
            whisper = self.configs.get("whisper", WhisperConfig())
            if self.nets["slm_encoder"].cfg != whisper:
                raise ValueError(f"slm_encoder is built for {self.nets["slm_encoder"].cfg}, "
                                 f"configs['whisper'] is {whisper}")

        def step(batch, noise: Optional[Stage1Noise] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
            return self.step(batch, mel_len, mel_len_st, noise, generator, tma)
        return step

    def step(self, batch: Dict[str, torch.Tensor], mel_len: int, mel_len_st: int,
             noise: Optional[Stage1Noise] = None,
             generator: Optional[torch.Generator] = None,
             tma: bool = False) -> Dict[str, torch.Tensor]:
        """One step; ``noise`` drawn from ``generator`` when None.  Returns
        detached metrics on the device: ``mel_loss`` and ``g_loss``, and
        with ``tma`` also ``gen_loss``, ``mono_loss``, ``s2s_loss``,
        ``slm_loss`` and ``d_loss``."""
        mp: ModelParams = self.configs["model"]
        if noise is None:
            noise = Stage1Noise.draw(generator, self.nets, batch, mel_len)
        if tma:
            loss_mel, aux = stage1_loss(self.nets, mp, batch, noise, mel_len, mel_len_st,
                                        tma=True)
            return self.tma_update(loss_mel, aux)
        self.optimizer.zero_grad(TRAINED)
        loss, aux = stage1_loss(self.nets, mp, batch, noise, mel_len, mel_len_st)
        loss.backward()
        self.optimizer.step(TRAINED)
        return {"mel_loss": aux["mel_loss"], "g_loss": loss.detach()}

    def tma_update(self, loss_mel: torch.Tensor, aux: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """The TMA phase's two updates after the forward: the discriminator
        step, then the generator step against the updated discriminators
        (ref: train_first.py:391-430)."""
        nets = self.nets
        self.optimizer.zero_grad(DISCRIMINATORS)
        d_loss = discriminator_step_loss(nets["mpd"], nets["msd"], aux["wav"], aux["y_rec"])
        d_loss.backward()
        self.optimizer.step(DISCRIMINATORS)

        self.optimizer.zero_grad(TMA_TRAINED)
        with frozen(nets[n] for n in DISCRIMINATORS + ("slm_encoder",)):
            g_loss, metrics = tma_generator_loss(
                nets, self.config.loss_params, loss_mel, aux,
                self.configs["model"].slm.hop_length, self.remat_discriminators)
            g_loss.backward()
        self.optimizer.step(TMA_TRAINED)
        return {"mel_loss": aux["mel_loss"], **metrics, "g_loss": g_loss.detach(),
                "d_loss": d_loss.detach()}
