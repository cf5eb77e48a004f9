"""Multispeaker stage 2 and the fine-tune recipe against a JAX composition
of the JAX ``Stage2Trainer``'s lines, on the CPU at the tiny size.

The JAX side is written here from ``styletts2_tpu/train/stage2.py:116-320``
for a multispeaker model (``style_conditioned`` denoiser, the reference
styles of the batch's ``ref_waves``, the clip styles from a second clip)
and ``finetune`` as a 0/1 weight, over the JAX package's functions, and
jitted once; the JAX ``make_step`` is not compiled (minutes on a CPU).  The
alignment runs in its eval form on both sides (no dropout draws, as
``test_torch_stage1.py``), with gradients; the 50% choice of the monotonic
path is an argument.  The decoder is ``test_torch_slmadv``'s smooth
stand-in on both sides, as in ``test_torch_stage2.py`` (the HiFi-GAN
decoder is held by ``test_torch_hifigan_train.py``).  Held:
- with diffusion and joint: the generator loss, every metric,
  ``sigma_data``, and the gradients to each trained net, the prosody style
  encoder's and (joint) the style encoder's through the reference styles
  the style-conditioned denoiser takes as ``features`` included;
- a fine-tune step under both alignment draws: the trained alignment, the
  ``mono`` and ``s2s`` losses, and the gradients to every net it trains,
  the text encoder and the aligner included;
- ``slm_adversarial`` with the reference style (the sampler's
  ``features``): the generator loss and its gradients.
Tolerances as ``test_torch_stage2.py``: losses and metrics 1e-5 relative,
gradients at max|diff| <= 1e-4 max|g_leaf| + 1e-5 max|g_net|.
"""

import copy
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from styletts2_tpu.config import SlmAdvParams as JSlmAdvParams
from styletts2_tpu.losses.gan import generator_loss_full
from styletts2_tpu.losses.slm import slm_feature_loss
from styletts2_tpu.losses.slmadv import slm_adversarial as j_slm_adversarial
from styletts2_tpu.losses.stft_loss import multi_resolution_stft_loss
from styletts2_tpu.models import discriminators as j_disc
from styletts2_tpu.models.decoder import istftnet as j_istftnet
from styletts2_tpu.models.diffusion import sampler as j_S
from styletts2_tpu.models.diffusion.denoiser import denoiser_apply, fixed_embedding
from styletts2_tpu.models.jdc import jdc_apply
from styletts2_tpu.models.plbert import plbert_apply
from styletts2_tpu.models.predictor import prosody_duration_apply, prosody_f0n_apply
from styletts2_tpu.models.style_encoder import style_encoder_apply
from styletts2_tpu.models.text_encoder import text_encoder_apply
from styletts2_tpu.nn.linear import linear
from styletts2_tpu.train.stage1 import _clip_batch, compute_alignment
from styletts2_tpu_torch.config import Config, SlmAdvParams
from styletts2_tpu_torch.losses import slmadv as t_slmadv
from styletts2_tpu_torch.losses.slmadv import slm_adversarial
from styletts2_tpu_torch.models.asr import ASRNoise
from styletts2_tpu_torch.models.zoo import STAGE2_NETS
from styletts2_tpu_torch.train import stage2 as t_stage2
from styletts2_tpu_torch.train.stage1 import frozen, generator_adversarial_loss
from styletts2_tpu_torch.train.stage2 import SLM_GENERATOR, generator_nets, stage2_forward

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_aux import J_ASR, J_JDC  # noqa: E402
from test_torch_multispeaker import tiny_ms  # noqa: E402
from test_torch_slmadv import jax_draws as slm_draws  # noqa: E402
from test_torch_slmadv import standin_jax, standin_torch  # noqa: E402
from test_torch_stage2 import port_noise, stage2_batch  # noqa: E402
from test_torch_stage2_parts import assert_grads_close, port_grads, stage2_tiny, t_  # noqa

torch.set_num_threads(1)

B, MEL_LEN, STEPS, HOP = 2, 40, 3, 300
LP = Config().loss_params
ADV = dict(min_len=32, max_len=64, sig=1.5, iter=3)
CAPACITY = 50
# (diff, joint, start_ds, finetune)
PHASES = {"diffusion": (True, False, True, False), "joint": (True, True, True, False),
          "finetune": (True, True, True, True)}


@pytest.fixture(autouse=True)
def standin(monkeypatch):
    monkeypatch.setattr(j_istftnet, "decoder_apply", standin_jax)
    monkeypatch.setattr(t_stage2, "decoder_apply", standin_torch)
    monkeypatch.setattr(t_slmadv, "decoder_apply", standin_torch)
    j_disc.set_spec_conv_impl("plain")
    yield
    j_disc.set_spec_conv_impl("auto")


@functools.lru_cache(maxsize=None)
def ms_tiny():
    """``stage2_tiny``'s 14 nets with the tiny multispeaker model's
    style-conditioned denoiser, and the configs marked multispeaker: (JAX
    tree, the port's nets, JAX ModelParams, JAX PLBertConfig, JAX
    WhisperConfig, port ModelParams)."""
    zoo, nets, jmp, jpl, jcfg, mp = stage2_tiny()
    ms_zoo, ms_nets, *_ = tiny_ms()
    zoo = {**zoo, "diffusion": ms_zoo["diffusion"]}
    nets = copy.deepcopy(nets)
    nets["diffusion"] = copy.deepcopy(ms_nets["diffusion"])
    return (zoo, nets, dataclasses.replace(jmp, multispeaker=True), jpl, jcfg,
            dataclasses.replace(mp, multispeaker=True))


def ms_batch(seed=0):
    """``test_torch_stage2.stage2_batch`` with a same-speaker reference clip
    of 100 and 80 frames per sample."""
    batch = stage2_batch(seed)
    rng = np.random.default_rng(300 + seed)
    batch["ref_waves"] = (0.1 * rng.standard_normal((B, 100 * HOP))).astype(np.float32)
    batch["ref_frame_lengths"] = np.array([100, 80])
    return batch


def torch_batch(batch):
    return {k: t_(v) if k in ("waves", "ref_waves") else t_(v).long()
            for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v, jnp.float32 if k in ("waves", "ref_waves") else jnp.int32)
            for k, v in batch.items()}


def j_gen_loss_fn(jmp, jpl, jcfg):
    """``gen_loss_fn`` of the JAX ``Stage2Trainer.make_step`` for a
    multispeaker model (stage2.py:116-320), the phase's branches as 0/1
    weights (``flags``: diff, joint, start_ds, finetune) and the alignment
    draw ``use_mono`` (stage2.py:131) as an argument.  Outside fine-tuning
    it takes the monotonic path, which is the value the other branch gives;
    the gradients that branch lets into the text encoder and the aligner are
    read only in fine-tuning, which trains them."""

    def gen_loss_fn(gen_params, frozen_params, batch, key, sigma_data_in, flags, use_mono):
        diff, joint, start_ds, finetune = flags
        zoo = {**frozen_params, **gen_params}
        mels = log_mel_spectrogram(batch["waves"], DATASET_MEL)
        mels = mels[..., : (mels.shape[-1] // 2) * 2]
        mel_lengths = batch["mel_input_length"]
        texts, text_lengths = batch["texts"], batch["input_lengths"]
        b, t_text = texts.shape
        _, s2s_pred, s2s_attn, mono = compute_alignment(
            zoo, mels, mel_lengths, texts, text_lengths, J_ASR, train=False, rng=None)
        t_en = text_encoder_apply(zoo["text_encoder"], texts, text_lengths)
        asr_full = t_en @ jnp.where(use_mono, mono, s2s_attn)
        d_gt = jax.lax.stop_gradient(jnp.sum(mono, axis=-1))
        s_dur_full = style_encoder_apply(zoo["predictor_encoder"], mels[:, None], mel_lengths)
        gs_full = style_encoder_apply(zoo["style_encoder"], mels[:, None], mel_lengths)
        s_trg = jax.lax.stop_gradient(jnp.concatenate([gs_full, s_dur_full], axis=-1))
        text_pad = jnp.arange(t_text)[None, :] + 1 > text_lengths[:, None]
        bert_dur = plbert_apply(zoo["bert"], texts, (~text_pad).astype(jnp.int32), jpl)
        d_en = jnp.swapaxes(linear(bert_dur, zoo["bert_encoder"]["weight"],
                                   zoo["bert_encoder"]["bias"]), 1, 2)
        # the reference styles (stage2.py:157-164)
        ref_mels = log_mel_spectrogram(batch["ref_waves"], DATASET_MEL)
        ref_len = batch["ref_frame_lengths"]
        ref_style = jnp.concatenate(
            [style_encoder_apply(zoo["style_encoder"], ref_mels[:, None], ref_len),
             style_encoder_apply(zoo["predictor_encoder"], ref_mels[:, None], ref_len)], -1)
        heads = jmp.diffusion.transformer.num_heads
        estimate = jnp.mean(jnp.std(s_trg.astype(jnp.float32), axis=-1))
        sigma_data = jnp.where(diff > 0, estimate, sigma_data_in)

        def net_train(x, c_noise):
            mask = jax.random.bernoulli(jax.random.fold_in(key, 20),
                                        jmp.diffusion.embedding_mask_proba, (b, 1, 1))
            fix = fixed_embedding(zoo["diffusion"]["transformer"], b, t_text)
            return denoiser_apply(zoo["diffusion"]["transformer"], x, c_noise,
                                  jnp.where(mask, fix, bert_dur), features=ref_style,
                                  num_heads=heads, style_conditioned=True)

        loss_diff = diff * j_S.k_diffusion_loss(
            jax.random.fold_in(key, 21), net_train, s_trg[:, None, :], sigma_data,
            jmp.diffusion.dist.mean, jmp.diffusion.dist.std)

        def net_eval(x, c_noise):
            return denoiser_apply(zoo["diffusion"]["transformer"], x, c_noise,
                                  jax.lax.stop_gradient(bert_dur),
                                  features=jax.lax.stop_gradient(ref_style), num_heads=heads,
                                  style_conditioned=True)

        noise = jax.random.normal(jax.random.fold_in(key, 22), (b, 1, jmp.style_dim * 2))
        s_preds = j_S.adpm2_sample(jax.random.fold_in(key, 23), noise,
                                   j_S.k_denoise_fn(net_eval, sigma_data),
                                   j_S.karras_schedule(STEPS), STEPS, clamp=False)[:, 0, :]
        loss_sty = diff * jnp.mean(jnp.abs(s_preds - s_trg))
        dur_logits, p_full = prosody_duration_apply(
            zoo["predictor"], d_en, s_dur_full, text_lengths, mono, jmp.n_layer,
            train=True, rng=jax.random.fold_in(key, 24))
        half_len = mel_lengths // 2

        def starts_of(k):
            u = jax.random.uniform(jax.random.fold_in(key, k), (b,))
            return (u * jnp.maximum(half_len - MEL_LEN, 1).astype(jnp.float32)).astype(jnp.int32)

        starts = starts_of(25)
        en = _clip_batch(asr_full, starts, MEL_LEN, axis=2)
        p_en = _clip_batch(p_full, starts, MEL_LEN, axis=2)
        gt = jax.lax.stop_gradient(_clip_batch(mels, starts * 2, MEL_LEN * 2, axis=2))
        wav_clip = jax.lax.stop_gradient(
            _clip_batch(batch["waves"], starts * 2 * HOP, MEL_LEN * 2 * HOP, axis=1))
        st = jax.lax.stop_gradient(_clip_batch(mels, starts_of(26) * 2, MEL_LEN * 2, axis=2))
        s_dur_clip = style_encoder_apply(zoo["predictor_encoder"], st[:, None])
        s_clip = style_encoder_apply(zoo["style_encoder"], st[:, None])
        f0_real = jax.lax.stop_gradient(jdc_apply(zoo["pitch_extractor"], gt[:, None], J_JDC)[0])
        n_real = jax.lax.stop_gradient(log_norm(gt))
        y_rec_gt_pred = jax.lax.stop_gradient(j_istftnet.decoder_apply(
            zoo["decoder"], jmp.decoder, en, f0_real, n_real, s_clip))[:, 0, :]
        wav_target = jnp.where(joint > 0, wav_clip, y_rec_gt_pred)
        f0_fake, n_fake = prosody_f0n_apply(zoo["predictor"], p_en, s_dur_clip, train=True,
                                            rng=jax.random.fold_in(key, 27))
        y_rec = j_istftnet.decoder_apply(zoo["decoder"], jmp.decoder, en, f0_fake, n_fake,
                                         s_clip, key=jax.random.fold_in(key, 28), train=True)

        def smooth_l1(x, y):
            d = x - y
            return jnp.mean(jnp.where(jnp.abs(d) < 1.0, 0.5 * d * d, jnp.abs(d) - 0.5))

        loss_f0 = smooth_l1(f0_real, f0_fake) / 10.0
        loss_norm = smooth_l1(n_real, n_fake)
        loss_mel = multi_resolution_stft_loss(y_rec[:, 0, :], wav_target)
        y = wav_target[:, None, :]
        loss_gen_all = start_ds * generator_loss_full(
            j_disc.mpd_apply(zoo["mpd"], y, y_rec, batched=False),
            j_disc.msd_apply(zoo["msd"], y, y_rec, batched=False))
        loss_lm = slm_feature_loss(zoo["slm_encoder"], wav_target, y_rec[:, 0, :], jcfg,
                                   jmp.slm.hop_length)
        max_dur = dur_logits.shape[-1]
        token_keep = jnp.arange(t_text)[None, :] < text_lengths[:, None]
        trg = (jnp.arange(max_dur)[None, None, :] < d_gt[..., None]).astype(jnp.float32)
        bce = (jnp.maximum(dur_logits, 0) - dur_logits * trg
               + jnp.log1p(jnp.exp(-jnp.abs(dur_logits))))
        loss_ce = ((bce * token_keep[..., None]).sum((1, 2))
                   / jnp.maximum(token_keep.sum(1) * max_dur, 1)).mean()
        dur_pred = jax.nn.sigmoid(dur_logits).sum(-1)
        inner = (token_keep & (jnp.arange(t_text)[None, :] >= 1)
                 & (jnp.arange(t_text)[None, :] < (text_lengths - 1)[:, None]))
        loss_dur = ((jnp.abs(dur_pred - d_gt) * inner).sum(1)
                    / jnp.maximum(inner.sum(1), 1)).mean()
        # the fine-tune recipe's aligner losses (stage2.py:300-308)
        tk = token_keep.astype(jnp.float32)
        nll = -jnp.take_along_axis(jax.nn.log_softmax(s2s_pred[:, :-1, :], axis=-1),
                                   texts[..., None], axis=-1)[..., 0]
        loss_s2s = jnp.mean((nll * tk).sum(1) / jnp.maximum(tk.sum(1), 1))
        loss_mono = jnp.mean(jnp.abs(s2s_attn - mono)) * 10.0
        g_loss = (LP.lambda_mel * loss_mel + LP.lambda_F0 * loss_f0 + LP.lambda_ce * loss_ce
                  + LP.lambda_norm * loss_norm + LP.lambda_dur * loss_dur
                  + LP.lambda_gen * loss_gen_all + LP.lambda_slm * loss_lm
                  + LP.lambda_sty * loss_sty + LP.lambda_diff * loss_diff
                  + finetune * (LP.lambda_mono * loss_mono + LP.lambda_s2s * loss_s2s))
        metrics = dict(mel_loss=loss_mel, dur_loss=loss_dur, ce_loss=loss_ce,
                       norm_loss=loss_norm, F0_loss=loss_f0, lm_loss=loss_lm,
                       gen_loss=loss_gen_all, sty_loss=loss_sty, diff_loss=loss_diff,
                       mono_loss=loss_mono, s2s_loss=loss_s2s)
        return g_loss, {"sigma_data": sigma_data, "metrics": metrics, "ref_style": ref_style}

    return gen_loss_fn


GEN_NETS = generator_nets(True, True, True)


@functools.lru_cache(maxsize=None)
def j_gen_jit():
    _, _, jmp, jpl, jcfg, _ = ms_tiny()
    return jax.jit(jax.value_and_grad(j_gen_loss_fn(jmp, jpl, jcfg), has_aux=True))


def run_phase(phase, use_mono=True, seed=0):
    """The JAX ``gen_loss_fn`` and the port's ``stage2_forward`` with the GAN
    term, on the same draws; the port's gradients in its nets."""
    zoo, nets, jmp, *_, mp = ms_tiny()
    nets = copy.deepcopy(nets)
    diff, joint, start_ds, finetune = PHASES[phase]
    batch = ms_batch(seed)
    key = jax.random.PRNGKey(70 + seed)
    gen = {k: zoo[k] for k in GEN_NETS}
    fixed = {k: v for k, v in zoo.items() if k not in GEN_NETS}
    (j_g, j_aux), j_grads = j_gen_jit()(
        gen, fixed, jax_batch(batch), key, jnp.float32(0.2),
        tuple(jnp.float32(f) for f in PHASES[phase]), jnp.bool_(use_mono))
    tb = torch_batch(batch)
    noise = port_noise(key, nets, jmp, tb)
    noise.st_clip_u = t_(jax.random.uniform(jax.random.fold_in(key, 26), (B,)))
    if finetune:
        noise.asr, noise.use_mono = ASRNoise(), torch.tensor(use_mono)
    trained = generator_nets(diff, joint, finetune)
    with frozen(nets[n] for n in nets if n not in trained):
        g_partial, aux = stage2_forward(nets, mp, LP, tb, noise, MEL_LEN, STEPS, diff, joint,
                                        0.2, finetune)
        loss_gen = generator_adversarial_loss(nets["mpd"], nets["msd"], aux["wav_target"],
                                              aux["y_rec"])
        g_loss = g_partial + LP.lambda_gen * loss_gen
        g_loss.backward()
    return (j_g, j_aux, j_grads), (g_loss, aux, loss_gen), nets, trained


def check_phase(phase, use_mono=True):
    (j_g, j_aux, j_grads), (g_loss, aux, loss_gen), nets, trained = run_phase(phase, use_mono)
    np.testing.assert_allclose(float(g_loss), float(j_g), rtol=1e-5)
    ours = {**aux["metrics"], "gen_loss": loss_gen}
    finetune = PHASES[phase][3]
    assert ({"mono_loss", "s2s_loss"} <= set(ours)) == finetune
    for k, v in j_aux["metrics"].items():
        if k in ours:
            np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-5,
                                       atol=1e-5 * abs(float(j_g)), err_msg=k)
    np.testing.assert_allclose(float(aux["sigma_data"]), float(j_aux["sigma_data"]), rtol=1e-5)
    np.testing.assert_allclose(aux["ref_style"].detach().numpy(), np.asarray(j_aux["ref_style"]),
                               rtol=1e-5, atol=1e-6)
    for name in trained:
        if name == "decoder":           # the stand-in holds no parameter
            continue
        assert_grads_close(j_grads[name], port_grads(nets[name]), rtol=1e-4, net_tol=1e-5)
    for name in STAGE2_NETS:
        if name not in trained:
            assert all(p.grad is None for p in nets[name].parameters()), name
    return nets


@pytest.mark.parametrize("phase", ["diffusion", "joint"])
def test_multispeaker_generator_loss_and_gradients(phase):
    """The reference styles reach the diffusion loss as the denoiser's
    ``features``: the prosody style encoder (and, joint, the style encoder)
    take gradients through them."""
    nets = check_phase(phase)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0
               for p in nets["predictor_encoder"].parameters())


@pytest.mark.parametrize("use_mono", [False, True])
def test_finetune_step_under_both_alignment_draws(use_mono):
    """The trained alignment (soft or monotonic), the mono and s2s losses,
    and the gradients to every net, the text encoder and the aligner
    included."""
    nets = check_phase("finetune", use_mono)
    for name in ("text_encoder", "text_aligner"):
        assert max(float(p.grad.abs().max()) for p in nets[name].parameters()
                   if p.grad is not None) > 0, name


@functools.lru_cache(maxsize=None)
def j_slm_jit():
    _, _, jmp, jpl, jcfg, _ = ms_tiny()

    def loss(train, fixed, batch, key, y_rec_gt, y_pred_gt, s_trg, ref_style):
        out = j_slm_adversarial(
            {**fixed, **train}, key, jmp, jpl, jcfg, JSlmAdvParams(**ADV), batch["ref_texts"],
            batch["ref_lengths"], batch["waves"], batch["mel_input_length"], y_rec_gt,
            y_pred_gt, s_trg, ref_style, num_steps=STEPS, use_ind_style=False,
            run_discriminator=False, frame_capacity=CAPACITY, mel_len=16, sigma_data=0.25)
        return out.gen_loss

    return jax.jit(jax.value_and_grad(loss))


def test_slm_adversarial_with_the_reference_style():
    """The sampler of the SLM pass denoises with the reference style as
    ``features``: the generator loss and its gradients to the four nets it
    trains."""
    zoo, nets, jmp, *_, mp = ms_tiny()
    nets = copy.deepcopy(nets)
    rng = np.random.default_rng(4)
    batch = ms_batch(1)
    y_rec_gt, y_pred_gt = ((0.1 * rng.standard_normal((B, 16 * 600))).astype(np.float32)
                           for _ in range(2))
    s_trg, ref_style = ((0.3 * rng.standard_normal((B, 2 * jmp.style_dim))).astype(np.float32)
                        for _ in range(2))
    key = jax.random.PRNGKey(90)
    train = {k: zoo[k] for k in SLM_GENERATOR}
    fixed = {k: v for k, v in zoo.items() if k not in SLM_GENERATOR}
    j_loss, j_grads = j_slm_jit()(train, fixed, jax_batch(batch), key, *(
        jnp.asarray(v) for v in (y_rec_gt, y_pred_gt, s_trg, ref_style)))
    tb = torch_batch(batch)
    noise = slm_draws(key, jmp, B, batch["ref_texts"].shape[1], STEPS)
    with frozen(nets[n] for n in nets if n not in SLM_GENERATOR):
        out = slm_adversarial(nets, mp, SlmAdvParams(**ADV), tb["ref_texts"], tb["ref_lengths"],
                              tb["waves"], tb["mel_input_length"], t_(y_rec_gt), t_(y_pred_gt),
                              t_(s_trg), noise, STEPS, False, False, CAPACITY, mel_len=16,
                              sigma_data=0.25, ref_style=t_(ref_style))
        out.gen_loss.backward()
    assert float(out.valid_fraction) > 0
    np.testing.assert_allclose(float(out.gen_loss), float(j_loss), rtol=1e-5)
    for name in SLM_GENERATOR:
        assert_grads_close(j_grads[name], port_grads(nets[name]), rtol=1e-4, net_tol=1e-5)
    with pytest.raises(ValueError, match="features"):
        slm_adversarial(nets, mp, SlmAdvParams(**ADV), tb["ref_texts"], tb["ref_lengths"],
                        tb["waves"], tb["mel_input_length"], t_(y_rec_gt), t_(y_pred_gt),
                        t_(s_trg), noise, STEPS, False, False, CAPACITY, mel_len=16)
