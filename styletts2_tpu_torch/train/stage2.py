"""Stage-2 training: the prosody predictor and durations, the style
diffusion, and the joint SLM adversarial training (ref:
train_second.py:174-1245; the JAX package's ``train/stage2.py``).

The forward of one step: the log-mel of the batch; the frozen aligner and
the monotonic path (kernel K3) and the frozen text encoder, with no graph;
the whole utterance's styles from the style encoder (a constant) and the
prosody style encoder; PL-BERT and ``bert_encoder``; with diffusion (from
``diff_epoch``) the EDM loss of the denoiser on the ground-truth styles and
the style reconstruction of an ADPM2 sample; the duration head and the
prosody encoding over the monotonic alignment, with dropout; one clip per
sample; the pitch extractor and the decoder on the ground-truth F0 and
energy (``y_rec_gt_pred``, no graph); the F0/N head, with dropout, and the
training decoder, iSTFTNet or HiFi-GAN (its 48 or 96 AdaIN -> Snake pairs
through kernels K1f/K1b), on the predicted curves; and the losses: STFT, F0,
energy, duration CE and L1, the Whisper feature loss, the style and
diffusion losses.

A multispeaker model (``mp.multispeaker``) also takes, with diffusion, the
reference styles of the batch's same-speaker clips (``ref_waves``: the
style encoder's and the prosody style encoder's, concatenated) as the
style-conditioned denoiser's ``features``, in the diffusion loss (with
gradients), the sampled styles and the SLM adversarial pass (constants), and
its clip styles come from a second random clip of the utterance.

The fine-tune recipe (``finetune``; ref: train_finetune.py) trains every
net from step 0: the text encoder and the aligner join the generator step,
the alignment runs in its training form (the aligner's and the text
encoder's dropout, and the 50% choice of the monotonic path over the soft
alignment as explicit draws), and the aligner's ``mono`` and ``s2s`` losses
are added.

Then, in this order:
1. from ``diff_epoch`` (``start_ds``): the MPD/MSD step on the detached
   waveform, and AdamW on ``mpd`` and ``msd``;
2. the generator step against the updated discriminators (the GAN loss is
   added to the forward's), its graph the forward's, and AdamW on
   ``bert_encoder``, ``bert``, ``predictor``, ``predictor_encoder``, with
   diffusion ``diffusion``, and from ``joint_epoch`` ``style_encoder`` and
   ``decoder``;
3. from ``joint_epoch``: ``losses.slmadv.slm_adversarial`` with the updated
   nets, either the generator update of ``bert_encoder``, ``bert``,
   ``predictor`` and ``diffusion`` (their gradients clipped to a global
   norm, and the diffusion's and the duration head's scaled by 0.01) or,
   every ``slmadv_params.iter``-th batch, the Whisper discriminator's.
Before ``joint_epoch`` the decoder is frozen and the waveform target is its
own reconstruction ``y_rec_gt_pred``; from then on it is the recording.
Outside the fine-tune recipe the text encoder and the aligner never train;
the pitch extractor and the Whisper encoder never do.

Every random input of the step is an explicit tensor of ``Stage2Noise``,
drawn in one place from a ``torch.Generator``, so the tests can feed the
draws the JAX package makes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from ..config import Config, LossParams, ModelParams
from ..losses.slm import slm_feature_loss
from ..losses.slmadv import EMBEDDING_MASK_PROBA, SlmAdvNoise, slm_adversarial
from ..losses.stft_loss import multi_resolution_stft_loss
from ..models.asr import ASRNoise
from ..models.decoder import decoder_apply
from ..models.decoder.istftnet import F0_SMOOTH, N_SMOOTH
from ..models.diffusion import sampler as S
from ..models.diffusion.denoiser import denoiser_apply, fixed_embedding
from ..models.jdc import jdc_apply
from ..models.plbert import plbert_apply
from ..models.predictor import (ENCODER_DROPOUT, F0N_DROPOUT, LSTM_DROPOUT,
                                duration_dropout_shapes, f0n_dropout_shapes,
                                prosody_duration_apply, prosody_f0n_apply)
from ..models.style_encoder import style_encoder_apply
from ..models.text_encoder import text_encoder_apply
from ..models.whisper import WhisperConfig
from ..models.zoo import STAGE2_NETS
from ..nn.linear import linear
from .optimizers import MultiOptimizer, clip_by_global_norm_if_above, scale_module_grads
from .stage1 import (DISCRIMINATORS, HOP, clip_batch, clip_starts, compute_alignment,
                     discriminator_step_loss, draw_alignment_noise, frozen,
                     generator_adversarial_loss, mono_loss, s2s_loss)

PROSODY = ("bert_encoder", "bert", "predictor", "predictor_encoder")
ACOUSTIC = ("style_encoder", "decoder")
SLM_GENERATOR = ("bert_encoder", "bert", "predictor", "diffusion")
SLM_DISCRIMINATOR = ("wd",)
ALIGNMENT = ("text_encoder", "text_aligner")


def generator_nets(diff: bool, joint: bool, finetune: bool = False) -> Tuple[str, ...]:
    """The nets the generator step trains (ref: train_second.py,
    train_finetune.py; the JAX package's ``stage2.py:101-104``)."""
    return (PROSODY + (("diffusion",) if diff else ()) + (ACOUSTIC if joint or finetune else ())
            + (ALIGNMENT if finetune else ()))


def _smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.smooth_l1_loss(x, y, beta=1.0)


@dataclasses.dataclass
class Stage2Noise:
    """The random inputs of one stage-2 step.

    emb_mask (B, 1, 1) bool: the diffusion loss's denoiser sees the fixed
    embedding instead of PL-BERT's; sigma_normals (B,) standard normals of
    the log-normal training sigmas and diff_noise (B, 1, 2 * style_dim) the
    noise they scale; sample_noise (B, 1, 2 * style_dim) and
    sample_step_noise (num_steps - 1, B, 1, 2 * style_dim): the style
    reconstruction's ADPM2 sample; dur_encoder_keep, dur_lstm_keep: the
    predictor's dropout over the batch's tokens
    (``models.predictor.duration_dropout_shapes``); clip_u (B,) uniforms in
    [0, 1): the clip starts; f0n_keep: the F0/N head's dropout
    (``f0n_dropout_shapes``); f0_smooth, n_smooth 0-dim int indices into the
    decoder's ``F0_SMOOTH`` and ``N_SMOOTH``; source_noise (B, harmonics,
    T_audio): the harmonic source's dither; slm: the SLM adversarial pass's
    (``losses.slmadv.SlmAdvNoise``), over texts of the longer of the batch's
    and the reference texts; st_clip_u (B,) uniforms in [0, 1): the style
    clip's starts (a multispeaker model's clip styles).  The fine-tune
    recipe's trained alignment (None otherwise, each as in
    ``stage1.Stage1Noise``): asr, the aligner's dropout and token masking;
    text_keep, the text encoder's dropout; use_mono, the 0-dim bool choice
    of the monotonic path over the soft alignment.
    """

    emb_mask: torch.Tensor
    sigma_normals: torch.Tensor
    diff_noise: torch.Tensor
    sample_noise: torch.Tensor
    sample_step_noise: torch.Tensor
    dur_encoder_keep: torch.Tensor
    dur_lstm_keep: torch.Tensor
    clip_u: torch.Tensor
    f0n_keep: List[Tuple[torch.Tensor, torch.Tensor]]
    f0_smooth: torch.Tensor
    n_smooth: torch.Tensor
    source_noise: torch.Tensor
    slm: SlmAdvNoise
    st_clip_u: Optional[torch.Tensor] = None
    asr: Optional[ASRNoise] = None
    text_keep: Optional[torch.Tensor] = None
    use_mono: Optional[torch.Tensor] = None

    @classmethod
    def draw(cls, generator: torch.Generator, nets: nn.ModuleDict,
             batch: Dict[str, torch.Tensor], mel_len: int, num_steps: int,
             embedding_mask_proba: float = 0.1, finetune: bool = False) -> "Stage2Noise":
        """Every draw of one step from ``generator``, on the batch's device;
        the shapes follow ``nets``, the batch, the clip length and the
        sampler's ``num_steps``; the trained alignment's with ``finetune``."""
        texts = batch["texts"]
        dev = texts.device
        b, t_text = texts.shape
        t_slm = max(t_text, batch["ref_texts"].shape[1])
        predictor, gen = nets["predictor"], nets["decoder"].generator
        latent = (b, 1, nets["diffusion"]["transformer"].to_out["1"].out_channels)
        harmonics = gen.m_source.l_linear.weight.shape[1]

        def u(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        def keep(shape, p):
            return u(*shape) < 1.0 - p

        def duration_keep(t):
            enc, lstm = duration_dropout_shapes(predictor, b, t)
            return keep(enc, ENCODER_DROPOUT), keep(lstm, LSTM_DROPOUT)

        dur_enc, dur_lstm = duration_keep(t_text)
        slm_enc, slm_lstm = duration_keep(t_slm)
        noise = cls(
            emb_mask=u(b, 1, 1) < embedding_mask_proba,
            sigma_normals=normal(b), diff_noise=normal(*latent),
            sample_noise=normal(*latent), sample_step_noise=normal(num_steps - 1, *latent),
            dur_encoder_keep=dur_enc, dur_lstm_keep=dur_lstm, clip_u=u(b),
            f0n_keep=[(keep(s1, F0N_DROPOUT), keep(s2, F0N_DROPOUT))
                      for s1, s2 in f0n_dropout_shapes(predictor, b, mel_len)],
            f0_smooth=torch.randint(0, len(F0_SMOOTH), (), generator=generator, device=dev),
            n_smooth=torch.randint(0, len(N_SMOOTH), (), generator=generator, device=dev),
            source_noise=normal(b, harmonics, mel_len * 2 * gen.samples_per_frame),
            slm=SlmAdvNoise(
                emb_mask=u(b, 1, 1) < EMBEDDING_MASK_PROBA, noise=normal(*latent),
                step_noise=normal(num_steps - 1, *latent), dur_encoder_keep=slm_enc,
                dur_lstm_keep=slm_lstm, align_encoder_keep=duration_keep(t_slm)[0],
                pred_u=u(b), gt_u=u(b)))
        noise.st_clip_u = u(b)
        if finetune:
            noise.asr, noise.text_keep, noise.use_mono = draw_alignment_noise(
                generator, nets, batch)
        return noise


def duration_losses(dur_logits: torch.Tensor, d_gt: torch.Tensor, text_lengths: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked duration BCE over ``max_dur`` bins and the L1 of the
    summed sigmoids without the first and the last token (ref:
    train_second.py:741-755), in f32: ``(loss_ce, loss_dur)``."""
    t_text = dur_logits.shape[1]
    logits = dur_logits.float()
    max_dur = logits.shape[-1]
    pos = torch.arange(t_text, device=logits.device)[None, :]
    token_keep = pos < text_lengths[:, None]
    trg = (torch.arange(max_dur, device=logits.device)[None, None, :]
           < d_gt[..., None]).float()
    bce = torch.clamp(logits, min=0) - logits * trg + torch.log1p(torch.exp(-torch.abs(logits)))
    per_sample_ce = ((bce * token_keep[..., None]).sum((1, 2))
                     / torch.clamp(token_keep.sum(1) * max_dur, min=1))
    dur_pred = torch.sigmoid(logits).sum(-1)
    inner = token_keep & (pos >= 1) & (pos < (text_lengths - 1)[:, None])
    per_sample_dur = (torch.abs(dur_pred - d_gt) * inner).sum(1) / torch.clamp(inner.sum(1),
                                                                              min=1)
    return per_sample_ce.mean(), per_sample_dur.mean()


def stage2_forward(nets: nn.ModuleDict, mp: ModelParams, lp: LossParams,
                   batch: Dict[str, torch.Tensor], noise: Stage2Noise, mel_len: int,
                   num_steps: int, diff: bool, joint: bool, sigma_data, finetune: bool = False
                   ) -> Tuple[torch.Tensor, Dict]:
    """The forward of one step to every generator loss term but the GAN's:
    ``(g_loss_without_gan, aux)``.  ``aux`` holds ``y_rec`` (B, 1,
    T_clip) with its graph, the constants ``wav_target``, ``y_rec_gt`` (the
    recording's clip), ``y_rec_gt_pred``, ``s_trg`` and ``sigma_data`` (the
    batch's estimate with diffusion, else the one given), ``ref_style``
    (a multispeaker model's reference styles with diffusion, with their
    graph, else None), and the detached loss terms under the JAX package's
    metric names.  A multispeaker batch also holds ``ref_waves`` (B, T_ref)
    and ``ref_frame_lengths`` (B,).  Run it with the nets that do not train
    frozen (``Stage2Trainer``)."""
    waves = batch["waves"]
    mels = log_mel_spectrogram(waves, DATASET_MEL)
    mels = mels[..., : (mels.shape[-1] // 2) * 2]
    mel_lengths = batch["mel_input_length"]
    texts, text_lengths = batch["texts"], batch["input_lengths"]
    b, t_text = texts.shape
    dev = texts.device

    if finetune:
        # the trained alignment (ref: train_finetune.py:380-404)
        _, s2s_pred, s2s_attn, mono = compute_alignment(nets["text_aligner"], mels, mel_lengths,
                                                        texts, text_lengths, noise.asr)
        t_en = text_encoder_apply(nets["text_encoder"], texts, text_lengths, noise.text_keep)
        asr_full = t_en @ torch.where(noise.use_mono, mono, s2s_attn)
    else:
        with torch.no_grad():
            *_, mono = compute_alignment(nets["text_aligner"], mels, mel_lengths, texts,
                                         text_lengths)
            asr_full = text_encoder_apply(nets["text_encoder"], texts, text_lengths) @ mono
    with torch.no_grad():
        gs_full = style_encoder_apply(nets["style_encoder"], mels[:, None], mel_lengths)
    d_gt = mono.sum(-1)
    s_dur_full = style_encoder_apply(nets["predictor_encoder"], mels[:, None], mel_lengths)
    s_trg = torch.cat([gs_full, s_dur_full.detach()], dim=-1)

    text_keep = torch.arange(t_text, device=dev)[None, :] < text_lengths[:, None]
    bert_dur = plbert_apply(nets["bert"], texts, text_keep.to(torch.int32))
    be = nets["bert_encoder"]
    d_en = linear(bert_dur, be.weight, be.bias).transpose(1, 2)

    ref_style = None
    if mp.multispeaker and diff:
        # the same speaker's reference clip (ref: train_second.py:581-592)
        ref_mels = log_mel_spectrogram(batch["ref_waves"], DATASET_MEL)[:, None]
        ref_len = batch["ref_frame_lengths"]
        ref_style = torch.cat([style_encoder_apply(nets["style_encoder"], ref_mels, ref_len),
                               style_encoder_apply(nets["predictor_encoder"], ref_mels, ref_len)],
                              dim=-1)

    zero = torch.zeros((), device=dev)
    if diff:
        dist = mp.diffusion.dist
        if dist.estimate_sigma_data:
            # the population std, as jnp.std (stage2.py:171)
            sigma_data = torch.mean(torch.std(s_trg.float(), dim=-1, correction=0))
        transformer = nets["diffusion"]["transformer"]
        emb = torch.where(noise.emb_mask, fixed_embedding(transformer, b, t_text), bert_dur)
        loss_diff = S.k_diffusion_loss(
            lambda x, c_noise: denoiser_apply(transformer, x, c_noise, emb, features=ref_style),
            s_trg[:, None, :], sigma_data, noise.sigma_normals, noise.diff_noise, dist.mean,
            dist.std)
        bert_const = bert_dur.detach()
        ref_const = None if ref_style is None else ref_style.detach()
        s_preds = S.adpm2_sample(
            noise.sample_noise,
            S.k_denoise_fn(lambda x, c_noise: denoiser_apply(
                transformer, x, c_noise, bert_const, features=ref_const), sigma_data),
            S.karras_schedule(num_steps, device=dev), num_steps, noise.sample_step_noise,
            clamp=False)[:, 0, :]
        loss_sty = torch.mean(torch.abs(s_preds - s_trg))
    else:
        loss_diff = loss_sty = zero

    predictor = nets["predictor"]
    dur_logits, p_full = prosody_duration_apply(predictor, d_en, s_dur_full, text_lengths, mono,
                                                noise.dur_encoder_keep, noise.dur_lstm_keep)

    starts = clip_starts(noise.clip_u, mel_lengths // 2, mel_len)
    en = clip_batch(asr_full, starts, mel_len)
    p_en = clip_batch(p_full, starts, mel_len)
    gt = clip_batch(mels, starts * 2, mel_len * 2)
    wav_clip = clip_batch(waves, starts * 2 * HOP, mel_len * 2 * HOP)
    style_src = (clip_batch(mels, clip_starts(noise.st_clip_u, mel_lengths // 2, mel_len) * 2,
                            mel_len * 2) if mp.multispeaker else gt)

    s_dur_clip = style_encoder_apply(nets["predictor_encoder"], style_src[:, None])
    s_clip = style_encoder_apply(nets["style_encoder"], style_src[:, None])
    with torch.no_grad():
        f0_real, _, _ = jdc_apply(nets["pitch_extractor"], gt[:, None])
        n_real = log_norm(gt)
        y_rec_gt_pred = decoder_apply(nets["decoder"], en, f0_real, n_real, s_clip)[:, 0, :]
    wav_target = wav_clip if joint else y_rec_gt_pred

    f0_fake, n_fake = prosody_f0n_apply(predictor, p_en, s_dur_clip, dropout_keep=noise.f0n_keep)
    y_rec = decoder_apply(nets["decoder"], en, f0_fake, n_fake, s_clip,
                          source_noise=noise.source_noise,
                          smooth=(noise.f0_smooth, noise.n_smooth))

    loss_f0 = _smooth_l1(f0_real, f0_fake) / 10.0
    loss_norm = _smooth_l1(n_real, n_fake)
    loss_mel = multi_resolution_stft_loss(y_rec[:, 0, :].float(), wav_target.float())
    loss_lm = slm_feature_loss(nets["slm_encoder"], wav_target, y_rec[:, 0, :],
                               mp.slm.hop_length)
    loss_ce, loss_dur = duration_losses(dur_logits, d_gt, text_lengths)
    g_loss = (lp.lambda_mel * loss_mel + lp.lambda_F0 * loss_f0 + lp.lambda_ce * loss_ce
              + lp.lambda_norm * loss_norm + lp.lambda_dur * loss_dur + lp.lambda_slm * loss_lm
              + lp.lambda_sty * loss_sty + lp.lambda_diff * loss_diff)
    metrics = {"mel_loss": loss_mel, "dur_loss": loss_dur, "ce_loss": loss_ce,
               "norm_loss": loss_norm, "F0_loss": loss_f0, "lm_loss": loss_lm,
               "sty_loss": loss_sty, "diff_loss": loss_diff}
    if finetune:
        # the aligner's losses (ref: train_finetune.py:547-565)
        metrics["mono_loss"] = mono_loss(s2s_attn, mono)
        metrics["s2s_loss"] = s2s_loss(s2s_pred, texts, text_lengths)
        g_loss = (g_loss + lp.lambda_mono * metrics["mono_loss"]
                  + lp.lambda_s2s * metrics["s2s_loss"])
    aux = {"y_rec": y_rec, "wav_target": wav_target, "y_rec_gt": wav_clip,
           "y_rec_gt_pred": y_rec_gt_pred, "s_trg": s_trg, "ref_style": ref_style,
           "sigma_data": torch.as_tensor(sigma_data, dtype=torch.float32, device=dev),
           "metrics": {k: v.detach() for k, v in metrics.items()}}
    return g_loss, aux


@dataclasses.dataclass(frozen=True)
class Stage2Phase:
    """The static choices of one step: the phase (``diff``, ``joint``,
    ``start_ds``), the clip in decoder frames, the sampler's step count, and
    the SLM adversarial pass's (the discriminator step instead of the
    generator's, the ground-truth style, the reconstruction as the real
    side and the cropped real or fake, the alignment's frame budget), and
    the fine-tune recipe's (``finetune``: every net trains, with the
    alignment)."""

    diff: bool
    joint: bool
    start_ds: bool
    mel_len: int
    num_steps: int = 4
    slm_run_disc: bool = False
    slm_use_ind: bool = False
    slm_use_rec: bool = False
    slm_real_alt: bool = False
    slm_frame_capacity: int = 400
    finetune: bool = False


@dataclasses.dataclass
class Stage2Trainer:
    config: Config
    configs: Dict                   # {"model": ModelParams, "whisper": WhisperConfig}
    nets: nn.ModuleDict
    optimizer: MultiOptimizer

    def check_nets(self) -> None:
        missing = [n for n in STAGE2_NETS if n not in self.nets]
        if missing:
            raise ValueError(f"stage 2 needs the nets {missing} (models.zoo.STAGE2_NETS)")
        whisper = self.configs.get("whisper", WhisperConfig())
        if self.nets["slm_encoder"].cfg != whisper:
            raise ValueError(f"slm_encoder is built for {self.nets['slm_encoder'].cfg}, "
                             f"configs['whisper'] is {whisper}")

    def step(self, batch: Dict[str, torch.Tensor], phase: Stage2Phase, sigma_data,
             noise: Optional[Stage2Noise] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One step; ``noise`` drawn from ``generator`` when None.
        ``sigma_data`` is the diffusion's estimate so far (a float or a
        0-dim tensor).  Returns the detached metrics on the device and the
        new ``sigma_data`` (a 0-dim f32 tensor)."""
        nets = self.nets
        mp: ModelParams = self.configs["model"]
        if noise is None:
            noise = Stage2Noise.draw(generator, nets, batch, phase.mel_len, phase.num_steps,
                                     mp.diffusion.embedding_mask_proba, phase.finetune)
        trained = generator_nets(phase.diff, phase.joint, phase.finetune)
        fixed = [nets[n] for n in nets if n not in trained]
        with frozen(fixed):
            g_partial, aux = stage2_forward(nets, mp, self.config.loss_params, batch, noise,
                                            phase.mel_len, phase.num_steps, phase.diff,
                                            phase.joint, sigma_data, phase.finetune)
        metrics = self.generator_update(g_partial, aux, trained, phase.start_ds)
        if phase.joint:
            metrics.update(self.slm_update(batch, aux, phase, noise.slm))
        return metrics, aux["sigma_data"]

    def generator_update(self, g_partial: torch.Tensor, aux: Dict, trained: Tuple[str, ...],
                         start_ds: bool) -> Dict[str, torch.Tensor]:
        """With ``start_ds`` the MPD/MSD step on the detached waveforms; then
        the generator step against the updated discriminators, AdamW on
        ``trained``."""
        nets, opt = self.nets, self.optimizer
        y_rec, wav_target = aux["y_rec"], aux["wav_target"]
        d_loss = torch.zeros((), device=y_rec.device)
        if start_ds:
            opt.zero_grad(DISCRIMINATORS)
            d_loss = discriminator_step_loss(nets["mpd"], nets["msd"], wav_target, y_rec)
            d_loss.backward()
            opt.step(DISCRIMINATORS)
        opt.zero_grad(trained)
        with frozen(nets[n] for n in nets if n not in trained):
            # the MPD/MSD activations are recomputed in the backward, as in stage 1
            loss_gen = (generator_adversarial_loss(nets["mpd"], nets["msd"], wav_target, y_rec)
                        if start_ds else torch.zeros((), device=y_rec.device))
            g_loss = g_partial + self.config.loss_params.lambda_gen * loss_gen
            g_loss.backward()
        opt.step(trained)
        return {**aux["metrics"], "gen_loss": loss_gen.detach(), "g_loss": g_loss.detach(),
                "d_loss": d_loss.detach()}

    def slm_update(self, batch: Dict[str, torch.Tensor], aux: Dict, phase: Stage2Phase,
                   noise: SlmAdvNoise) -> Dict[str, torch.Tensor]:
        """The SLM adversarial update with the nets as the generator step
        left them (ref: train_second.py:788-899): the WD's (``wd``) or the
        generator's, whose gradients are clipped to the global norm
        ``slmadv_params.thresh`` over its four nets and then scaled by
        ``slmadv_params.scale`` in the diffusion and the duration head."""
        nets, opt = self.nets, self.optimizer
        adv = self.config.slmadv_params
        run_disc = phase.slm_run_disc
        keys = SLM_DISCRIMINATOR if run_disc else SLM_GENERATOR
        texts, lengths = ((batch["texts"], batch["input_lengths"]) if phase.slm_use_ind
                          else (batch["ref_texts"], batch["ref_lengths"]))
        opt.zero_grad(keys)
        with frozen(nets[n] for n in nets if n not in keys):
            out = slm_adversarial(
                nets, self.configs["model"], adv, texts, lengths, batch["waves"],
                batch["mel_input_length"], aux["y_rec_gt"], aux["y_rec_gt_pred"],
                aux["s_trg"].detach(), noise, phase.num_steps, phase.slm_use_ind, run_disc,
                phase.slm_frame_capacity, mel_len=min(adv.min_len // 2, phase.mel_len),
                use_rec=phase.slm_use_rec, real_alt=phase.slm_real_alt,
                sigma_data=aux["sigma_data"],
                ref_style=None if aux["ref_style"] is None else aux["ref_style"].detach())
            loss = out.d_loss if run_disc else out.gen_loss
            loss.backward()
        if not run_disc:
            clip_by_global_norm_if_above([nets[k] for k in keys], adv.thresh)
            predictor = nets["predictor"]
            scale_module_grads([nets["diffusion"], predictor.duration_proj, predictor.lstm],
                               adv.scale)
        opt.step(keys)
        return {"d_loss_slm" if run_disc else "gen_loss_slm": loss.detach(),
                "slm_valid_fraction": out.valid_fraction}
