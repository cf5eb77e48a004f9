"""SLM adversarial training (ref: Modules/slmadv.py; the JAX package's
``losses/slmadv.py``).

The whole text -> speech path on out-of-distribution (or the batch's own)
texts: a style drawn by the diffusion sampler, the predicted durations, the
differentiable Gaussian alignment, the F0/N head and the decoder, scored by
the Whisper discriminator (WD).  The reference's data-dependent skips (fewer
than two valid samples) are masked weights, as in the JAX package: invalid
samples weigh 0 and no Python branch reads a device value.  The choices the
host loop makes (the sampler's step count, the ground-truth style instead of
a drawn one, the discriminator step and its two draws) are arguments.

Every random input is an explicit tensor of ``SlmAdvNoise``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import ModelParams, SlmAdvParams
from ..models.decoder import decoder_apply
from ..models.diffusion import sampler as S
from ..models.diffusion.denoiser import denoiser_apply, fixed_embedding
from ..models.plbert import plbert_apply
from ..models.predictor import duration_encoder_apply, duration_logits, prosody_f0n_apply
from ..models.text_encoder import text_encoder_apply
from ..nn.linear import linear
from ..ops.alignment import gaussian_alignment
from ..train.stage1 import HOP, clip_batch
from .slm import (slm_discriminator_forward, slm_discriminator_loss, slm_generator_loss,
                  weighted_mean)

EMBEDDING_MASK_PROBA = 0.1      # the sampler's fixed-embedding rate (ref: slmadv.py:86)


@dataclasses.dataclass
class SlmAdvNoise:
    """The random inputs of ``slm_adversarial`` for B texts of up to L
    tokens (masks wider than the texts are cut to them).

    emb_mask (B, 1, 1) bool: the sampler's denoiser sees the fixed embedding
    instead of PL-BERT's (one draw for every sampler call); noise (B, 1,
    2 * style_dim) the sampler's initial latent and step_noise (num_steps -
    1, B, 1, 2 * style_dim) its ancestral noise; dur_encoder_keep (nlayers,
    B, L, d_hid) and dur_lstm_keep (B, L, d_hid): the predictor's dropout in
    the durations' pass; align_encoder_keep (nlayers, B, L, d_hid): the
    duration encoder's dropout in the prosody pass over the alignment;
    pred_u, gt_u (B,) uniforms in [0, 1): the clip starts in the predicted
    frames and in the recordings."""

    emb_mask: torch.Tensor
    noise: torch.Tensor
    step_noise: torch.Tensor
    dur_encoder_keep: torch.Tensor
    dur_lstm_keep: torch.Tensor
    align_encoder_keep: torch.Tensor
    pred_u: torch.Tensor
    gt_u: torch.Tensor


class SlmAdvOut(NamedTuple):
    d_loss: torch.Tensor
    gen_loss: torch.Tensor
    valid_fraction: torch.Tensor


def _starts(u: torch.Tensor, frames: torch.Tensor, mel_len: int) -> torch.Tensor:
    """``floor(u * max(frames - mel_len, 1))``, in f32 as the JAX package."""
    return (u * torch.clamp(frames - mel_len, min=1).to(torch.float32)).to(torch.int64)


def slm_adversarial(nets: nn.ModuleDict, mp: ModelParams, adv: SlmAdvParams,
                    ref_texts: torch.Tensor, ref_lengths: torch.Tensor,
                    waves: torch.Tensor, mel_input_length: torch.Tensor,
                    y_rec_gt: torch.Tensor, y_rec_gt_pred: torch.Tensor, s_trg: torch.Tensor,
                    noise: SlmAdvNoise, num_steps: int, use_ind_style: bool,
                    run_discriminator: bool, frame_capacity: int,
                    mel_len: Optional[int] = None, use_rec: bool = False,
                    real_alt: bool = False, sigma_data=0.2,
                    ref_style: Optional[torch.Tensor] = None) -> SlmAdvOut:
    """One SLM adversarial pass (ref: slmadv.py:45-171).

    ref_texts (B, L) and ref_lengths (B,): the texts spoken; waves (B, T)
    and mel_input_length (B,): the batch's recordings; y_rec_gt,
    y_rec_gt_pred (B, T_clip): the generator step's recording clip and its
    reconstruction; s_trg (B, 2 * style_dim) the ground-truth styles.  With
    ``use_ind_style`` the styles are s_trg instead of sampled.
    ``frame_capacity`` is the alignment's frame budget and ``mel_len`` the
    clip in decoder frames (at most ``adv.max_len // 2``).  ``sigma_data``
    is the diffusion's current estimate.  ``ref_style`` (B, 2 * style_dim):
    a multispeaker model's reference styles, the sampler's ``features``
    (ref: slmadv.py:86-95).

    ``gen_loss`` carries gradients to ``bert``, ``bert_encoder``,
    ``predictor`` and ``diffusion`` (through the frozen text encoder,
    decoder and Whisper encoder).  With ``run_discriminator`` the generator
    side runs with no graph and ``d_loss`` carries gradients to ``wd`` only:
    the discriminator step with its regularisers (``use_rec``,
    ``real_alt``); ``gen_loss`` is then 0."""
    b, length = ref_texts.shape
    dev = ref_texts.device
    style_dim = mp.style_dim
    mel_len = min(adv.min_len // 2 if mel_len is None else mel_len, adv.max_len // 2)
    text_keep = torch.arange(length, device=dev)[None, :] < ref_lengths[:, None]

    with torch.set_grad_enabled(torch.is_grad_enabled() and not run_discriminator):
        bert_dur = plbert_apply(nets["bert"], ref_texts, text_keep.to(torch.int32))
        be = nets["bert_encoder"]
        d_en = linear(bert_dur, be.weight, be.bias).transpose(1, 2)

        if use_ind_style:
            s_preds = s_trg
        else:
            transformer = nets["diffusion"]["transformer"]
            emb = torch.where(noise.emb_mask, fixed_embedding(transformer, b, length),
                              bert_dur.detach())

            def net(x, c_noise):
                return denoiser_apply(transformer, x, c_noise, emb, features=ref_style)

            s_preds = S.adpm2_sample(noise.noise, S.k_denoise_fn(net, sigma_data),
                                     S.karras_schedule(num_steps, device=dev), num_steps,
                                     noise.step_noise, clamp=False)[:, 0, :]
        s_dur, acoustic = s_preds[:, style_dim:], s_preds[:, :style_dim]

        predictor = nets["predictor"]
        d = duration_encoder_apply(predictor.text_encoder, d_en, s_dur, ref_lengths,
                                   noise.dur_encoder_keep[:, :, :length])
        logits = duration_logits(predictor, d, ref_lengths, noise.dur_lstm_keep[:, :length])
        attn, pred_frames = gaussian_alignment(logits, ref_lengths, frame_capacity, adv.sig)
        with torch.no_grad():
            t_en = text_encoder_apply(nets["text_encoder"], ref_texts, ref_lengths)
        asr_pred = t_en @ attn                                   # (B, C, frame_capacity)
        d_align = duration_encoder_apply(predictor.text_encoder, d_en, s_dur, ref_lengths,
                                         noise.align_encoder_keep[:, :, :length])
        p_pred = d_align.transpose(1, 2) @ attn

        mel_length_gt = mel_input_length // 2
        valid = (mel_length_gt > mel_len) & (pred_frames > mel_len)
        start_pred = _starts(noise.pred_u, pred_frames, mel_len)
        en = clip_batch(asr_pred, start_pred, mel_len)
        p_en = clip_batch(p_pred, start_pred, mel_len)
        f0_fake, n_fake = prosody_f0n_apply(predictor, p_en, s_dur)
        y_pred = decoder_apply(nets["decoder"], en, f0_fake, n_fake, acoustic)[:, 0, :]

    start_gt = _starts(noise.gt_u, mel_length_gt, mel_len)
    wav = clip_batch(waves, start_gt * 2 * HOP, mel_len * 2 * HOP)

    # per-sample validity, and the reference's at-least-two-valid rule
    # (ref: slmadv.py:183-190 raises SkipSLMAdversarial below 2)
    vf = valid.to(torch.float32)
    enough = (vf.sum() >= 2.0).to(torch.float32)
    weights = vf * enough
    hop = mp.slm.hop_length
    if run_discriminator:
        d_loss = slm_discriminator_step(nets, hop, wav, y_pred, y_rec_gt, y_rec_gt_pred,
                                        weights, enough, use_rec, real_alt)
        gen_loss = torch.zeros((), device=dev)
    else:
        gen_loss = slm_generator_loss(nets["slm_encoder"], nets["wd"], y_pred, hop,
                                      sample_weights=weights)
        d_loss = torch.zeros((), device=dev)
    return SlmAdvOut(d_loss, gen_loss, vf.mean())


def _per_sample_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean |a - b| over every axis but the batch's -> (B,)."""
    return torch.abs(a - b).reshape(a.shape[0], -1).mean(dim=-1)


def slm_discriminator_step(nets: nn.ModuleDict, hop: int, wav: torch.Tensor,
                           y_pred: torch.Tensor, y_rec_gt: torch.Tensor,
                           y_rec_gt_pred: torch.Tensor, weights: torch.Tensor,
                           enough: torch.Tensor, use_rec: bool, real_alt: bool
                           ) -> torch.Tensor:
    """The WD's loss with both regularisers (ref: slmadv.py:212-249; the JAX
    package's ``_slm_discriminator_step``); every waveform is a constant.

    Without ``use_rec``: the LSGAN loss of the recording clip ``wav``
    against ``y_pred``.  With it the real side is the reconstruction
    ``y_rec_gt_pred``, the longer of (real, fake) is also cropped to the
    shorter, the length-invariance term L1(D(cropped), D(whole)[:len]) is
    added, and ``real_alt`` puts the cropped one into the LSGAN loss.  Then
    the reconstruction-invariance term L1(D(y_rec_gt), D(y_rec_gt_pred))."""
    enc, wd = nets["slm_encoder"], nets["wd"]

    def fwd(x):
        return slm_discriminator_forward(enc, wd, x, hop)

    fake = y_pred.detach()
    if not use_rec:
        return slm_discriminator_loss(enc, wd, wav.detach(), fake, hop, sample_weights=weights)
    rec = y_rec_gt_pred.detach()
    t_rec, t_p = rec.shape[-1], fake.shape[-1]
    crop = min(t_rec, t_p)
    if t_rec > t_p:
        # the real side is longer: crop it (ref: slmadv.py:222-231)
        real_gp = rec[:, :crop]
        out_crop, out_org = fwd(real_gp), fwd(rec)
        loss_reg = weighted_mean(_per_sample_l1(out_crop, out_org[..., : out_crop.shape[-1]]),
                                 enough.expand(rec.shape[0]))
        d_loss = slm_discriminator_loss(enc, wd, real_gp if real_alt else rec, fake, hop,
                                        sample_weights=weights)
    else:
        # the fake side is longer: crop it (ref: slmadv.py:232-241)
        fake_gp = fake[:, :crop]
        out_crop, out_org = fwd(fake_gp), fwd(fake)
        loss_reg = weighted_mean(_per_sample_l1(out_crop, out_org[..., : out_crop.shape[-1]]),
                                 weights)
        d_loss = slm_discriminator_loss(enc, wd, rec, fake_gp if real_alt else fake, hop,
                                        sample_weights=weights)
    d_loss = d_loss + loss_reg
    # reconstruction invariance (ref: slmadv.py:243-249)
    return d_loss + torch.mean(torch.abs(fwd(y_rec_gt.detach()) - fwd(rec))) * enough
