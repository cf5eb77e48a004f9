"""The port's stage-2 step (``train/stage2.py``) against a JAX composition of
the JAX ``Stage2Trainer``'s lines, on the CPU at the tiny size.

The JAX side is written here from ``styletts2_tpu/train/stage2.py:116-403``
(single speaker, no finetune) over the JAX package's functions and jitted;
the JAX ``make_step`` is not compiled (minutes on a CPU).  The port is fed
the draws the JAX step makes from its key (``fold_in(key, 20..28)`` and the
SLM pass's ``fold_in(key, 50)``).

The step is split at the decoder's waveform ``y_rec``, as
``test_torch_tma.py`` splits stage 1's: both packages run
``test_torch_slmadv``'s smooth stand-in for ``decoder_apply`` (the decoder
is held by ``test_torch_stage1.py``; its STFT phases carry the branch cut of
ROADMAP.md section C).  Held here:
- each phase's generator loss, its metrics and ``sigma_data``, and its
  gradients to every net it trains: before diffusion; with diffusion and the
  MPD/MSD (``start_ds``); joint;
- the update order of a joint step: the MPD/MSD step, then the generator
  step against the updated discriminators, then the SLM adversarial update
  (its generator form with the global-norm clip and the 0.01 scales, or the
  WD's) with the nets the generator step left, each update's gradients and
  the final parameters against optax on the JAX gradients.

Tolerances: losses and metrics 1e-5 relative.  Gradients at max|diff| <=
1e-4 max|g_leaf| + 1e-5 max|g_net| (tighter than ``test_torch_stage1.py``'s
1e-3 for the step's backward: here the stand-in keeps the STFT phases out;
measured up to 3e-6 of a leaf's largest in every phase); the
discriminators' at 1e-4 of the leaf's and the net's largest, as
``test_torch_tma.py`` states, but the MSD's at 3e-3 of the net's largest
(``GRAD_TOL``: its TPRLS mask on near-tied scores).
"""

import copy
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from styletts2_tpu.audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from styletts2_tpu.config import SlmAdvParams as JSlmAdvParams
from styletts2_tpu.losses.gan import discriminator_loss_full, generator_loss_full
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
from styletts2_tpu.train import optimizers as j_opt
from styletts2_tpu.train.stage1 import _clip_batch, compute_alignment
from styletts2_tpu_torch.config import Config, OptimizerParams, SlmAdvParams
from styletts2_tpu_torch.losses import slmadv as t_slmadv
from styletts2_tpu_torch.models.predictor import f0n_dropout_shapes
from styletts2_tpu_torch.models.zoo import STAGE2_NETS, flatten
from styletts2_tpu_torch.train import stage2 as t_stage2
from styletts2_tpu_torch.train.optimizers import MultiOptimizer
from styletts2_tpu_torch.train.stage1 import frozen, generator_adversarial_loss
from styletts2_tpu_torch.train.stage2 import (Stage2Noise, Stage2Phase, Stage2Trainer,
                                              generator_nets, stage2_forward)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_aux import J_ASR, J_JDC  # noqa: E402
from test_torch_slmadv import jax_draws as slm_draws  # noqa: E402
from test_torch_slmadv import standin_jax, standin_torch  # noqa: E402
from test_torch_stage2_parts import (assert_grads_close, j_duration_keep, j_f0n_keep,  # noqa
                                     j_step_noise, port_grads, stage2_tiny, t_)
from test_torch_stage1 import make_batch  # noqa: E402

torch.set_num_threads(1)

B, MEL_LEN, STEPS, HOP = 2, 40, 3, 300
LP = Config().loss_params
ADV = dict(min_len=32, max_len=64, sig=1.5, iter=3)
CAPACITY = 50
PHASES = {"pre_diffusion": (False, False, False), "diffusion": (True, False, True),
          "joint": (True, True, True)}


@pytest.fixture(autouse=True)
def standin(monkeypatch):
    monkeypatch.setattr(j_istftnet, "decoder_apply", standin_jax)
    monkeypatch.setattr(t_stage2, "decoder_apply", standin_torch)
    monkeypatch.setattr(t_slmadv, "decoder_apply", standin_torch)
    j_disc.set_spec_conv_impl("plain")
    yield
    j_disc.set_spec_conv_impl("auto")


def stage2_batch(seed=0):
    """``test_torch_stage1.make_batch`` with reference texts of 10 tokens."""
    batch = make_batch(seed)
    rng = np.random.default_rng(100 + seed)
    batch["ref_texts"] = rng.integers(4, 179, (B, 10)).astype(np.int64)
    batch["ref_lengths"] = np.array([10, 7])
    return batch


def torch_batch(batch):
    out = {"waves": t_(batch["waves"])}
    for k in ("mel_input_length", "texts", "input_lengths", "ref_texts", "ref_lengths"):
        out[k] = t_(batch[k]).long()
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v, jnp.float32 if k == "waves" else jnp.int32)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the JAX step's lines (styletts2_tpu/train/stage2.py), with the stand-in
# ---------------------------------------------------------------------------

# the nets a generator step may train; the JAX function below differentiates
# all of them, and each test reads the ones its phase trains
GEN_NETS = generator_nets(True, True)


def j_gen_loss_fn(jmp, jpl, jcfg):
    """``gen_loss_fn`` of the JAX ``Stage2Trainer.make_step``
    (stage2.py:116-322), (g_loss, aux).  The phase's static branches are
    0/1 weights here (``flags``: diff, joint, start_ds), so one compiled
    function serves every phase: ``diff`` selects the batch's sigma_data
    estimate and weighs the diffusion and style losses, ``joint`` selects the
    recording as the waveform target, ``start_ds`` weighs the GAN loss."""

    def gen_loss_fn(gen_params, frozen_params, batch, key, sigma_data_in, flags):
        diff, joint, start_ds = flags
        zoo = {**frozen_params, **gen_params}
        mels = log_mel_spectrogram(batch["waves"], DATASET_MEL)
        mels = mels[..., : (mels.shape[-1] // 2) * 2]
        mel_lengths = batch["mel_input_length"]
        texts, text_lengths = batch["texts"], batch["input_lengths"]
        b = texts.shape[0]
        _, _, _, s2s_attn_mono = jax.lax.stop_gradient(compute_alignment(
            zoo, mels, mel_lengths, texts, text_lengths, J_ASR, train=False, rng=None))
        t_en = text_encoder_apply(zoo["text_encoder"], texts, text_lengths)
        asr_full = jax.lax.stop_gradient(t_en @ s2s_attn_mono)
        d_gt = jax.lax.stop_gradient(jnp.sum(s2s_attn_mono, axis=-1))
        s_dur_full = style_encoder_apply(zoo["predictor_encoder"], mels[:, None], mel_lengths)
        gs_full = style_encoder_apply(zoo["style_encoder"], mels[:, None], mel_lengths)
        s_trg = jax.lax.stop_gradient(jnp.concatenate([gs_full, s_dur_full], axis=-1))
        text_pad = jnp.arange(texts.shape[1])[None, :] + 1 > text_lengths[:, None]
        bert_dur = plbert_apply(zoo["bert"], texts, (~text_pad).astype(jnp.int32), jpl)
        d_en = jnp.swapaxes(linear(bert_dur, zoo["bert_encoder"]["weight"],
                                   zoo["bert_encoder"]["bias"]), 1, 2)
        heads = jmp.diffusion.transformer.num_heads
        estimate = jnp.mean(jnp.std(s_trg.astype(jnp.float32), axis=-1))
        sigma_data = jnp.where(diff > 0, estimate, sigma_data_in)

        def net_train(x, c_noise):
            mask = jax.random.bernoulli(jax.random.fold_in(key, 20),
                                        jmp.diffusion.embedding_mask_proba, (b, 1, 1))
            fix = fixed_embedding(zoo["diffusion"]["transformer"], b, bert_dur.shape[1])
            return denoiser_apply(zoo["diffusion"]["transformer"], x, c_noise,
                                  jnp.where(mask, fix, bert_dur), num_heads=heads)

        loss_diff = diff * j_S.k_diffusion_loss(
            jax.random.fold_in(key, 21), net_train, s_trg[:, None, :], sigma_data,
            jmp.diffusion.dist.mean, jmp.diffusion.dist.std)

        def net_eval(x, c_noise):
            return denoiser_apply(zoo["diffusion"]["transformer"], x, c_noise,
                                  jax.lax.stop_gradient(bert_dur), num_heads=heads)

        noise = jax.random.normal(jax.random.fold_in(key, 22), (b, 1, jmp.style_dim * 2))
        s_preds = j_S.adpm2_sample(jax.random.fold_in(key, 23), noise,
                                   j_S.k_denoise_fn(net_eval, sigma_data),
                                   j_S.karras_schedule(STEPS), STEPS, clamp=False)[:, 0, :]
        loss_sty = diff * jnp.mean(jnp.abs(s_preds - s_trg))
        dur_logits, p_full = prosody_duration_apply(
            zoo["predictor"], d_en, s_dur_full, text_lengths, s2s_attn_mono, jmp.n_layer,
            train=True, rng=jax.random.fold_in(key, 24))
        half_len = mel_lengths // 2
        u = jax.random.uniform(jax.random.fold_in(key, 25), (b,))
        starts = (u * jnp.maximum(half_len - MEL_LEN, 1).astype(jnp.float32)).astype(jnp.int32)
        en = _clip_batch(asr_full, starts, MEL_LEN, axis=2)
        p_en = _clip_batch(p_full, starts, MEL_LEN, axis=2)
        gt = jax.lax.stop_gradient(_clip_batch(mels, starts * 2, MEL_LEN * 2, axis=2))
        wav_clip = jax.lax.stop_gradient(
            _clip_batch(batch["waves"], starts * 2 * HOP, MEL_LEN * 2 * HOP, axis=1))
        s_dur_clip = style_encoder_apply(zoo["predictor_encoder"], gt[:, None])
        s_clip = style_encoder_apply(zoo["style_encoder"], gt[:, None])
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
        t_text = texts.shape[1]
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
        g_loss = (LP.lambda_mel * loss_mel + LP.lambda_F0 * loss_f0 + LP.lambda_ce * loss_ce
                  + LP.lambda_norm * loss_norm + LP.lambda_dur * loss_dur
                  + LP.lambda_gen * loss_gen_all + LP.lambda_slm * loss_lm
                  + LP.lambda_sty * loss_sty + LP.lambda_diff * loss_diff)
        metrics = dict(mel_loss=loss_mel, dur_loss=loss_dur, ce_loss=loss_ce,
                       norm_loss=loss_norm, F0_loss=loss_f0, lm_loss=loss_lm,
                       gen_loss=loss_gen_all, sty_loss=loss_sty, diff_loss=loss_diff)
        return g_loss, {"y_rec": y_rec, "wav_target": wav_target, "sigma_data": sigma_data,
                        "y_rec_gt": wav_clip, "y_rec_gt_pred": y_rec_gt_pred, "s_trg": s_trg,
                        "metrics": metrics}

    return gen_loss_fn


@functools.lru_cache(maxsize=None)
def j_gen_jit():
    _, _, jmp, jpl, jcfg, _ = stage2_tiny()
    return jax.jit(jax.value_and_grad(j_gen_loss_fn(jmp, jpl, jcfg), has_aux=True))


def j_gen_value_and_grad(phase, zoo, batch, key, sigma_data=0.2):
    """The JAX ``gen_loss_fn`` of ``phase`` on ``zoo``: ((g_loss, aux),
    gradients to every net in ``GEN_NETS``)."""
    gen, fixed = split(zoo, GEN_NETS)
    flags = tuple(jnp.float32(f) for f in PHASES[phase])
    return j_gen_jit()(gen, fixed, jax_batch(batch), key, jnp.float32(sigma_data), flags)


def split(zoo, keys):
    return {k: zoo[k] for k in keys}, {k: v for k, v in zoo.items() if k not in keys}


def port_noise(key, nets, jmp, batch):
    """The port's ``Stage2Noise`` from the JAX step's key (the decoder's
    draws aside: the stand-in takes none)."""
    b, t_text = batch["texts"].shape
    shape = (b, 1, 2 * jmp.style_dim)
    k_sig, k_noise = jax.random.split(jax.random.fold_in(key, 21))
    enc, lstm = j_duration_keep(jax.random.fold_in(key, 24), jmp.n_layer, b, t_text,
                                jmp.hidden_dim)
    f0n = j_f0n_keep(jax.random.fold_in(key, 27),
                     f0n_dropout_shapes(nets["predictor"], b, MEL_LEN))
    return Stage2Noise(
        emb_mask=t_(jax.random.bernoulli(jax.random.fold_in(key, 20), 0.1, (b, 1, 1))),
        sigma_normals=t_(jax.random.normal(k_sig, (b,))),
        diff_noise=t_(jax.random.normal(k_noise, shape)),
        sample_noise=t_(jax.random.normal(jax.random.fold_in(key, 22), shape)),
        sample_step_noise=t_(j_step_noise(jax.random.fold_in(key, 23), STEPS, shape)),
        dur_encoder_keep=t_(enc), dur_lstm_keep=t_(lstm),
        clip_u=t_(jax.random.uniform(jax.random.fold_in(key, 25), (b,))),
        f0n_keep=[(t_(a), t_(c)) for a, c in f0n],
        f0_smooth=torch.tensor(0), n_smooth=torch.tensor(0), source_noise=torch.zeros(1),
        slm=slm_draws(jax.random.fold_in(key, 50), jmp, b, batch["ref_texts"].shape[1], STEPS))


def assert_metrics_close(theirs, ours, total):
    """Each loss term within 1e-5 relative, or 1e-5 of the total it is a
    term of (the Whisper feature loss between two waveforms that share most
    of their content cancels)."""
    for k, v in theirs.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-5,
                                   atol=1e-5 * abs(float(total)), err_msg=k)


@pytest.mark.parametrize("phase", list(PHASES))
def test_generator_loss_and_gradients_per_phase(phase):
    """``stage2_forward`` and the GAN term against the JAX ``gen_loss_fn``:
    ``g_loss``, every metric, ``sigma_data``, and the gradients to each net
    the phase trains; the frozen nets take none."""
    zoo, nets, jmp, *_ = stage2_tiny()
    nets = copy.deepcopy(nets)
    diff, joint, start_ds = PHASES[phase]
    batch = stage2_batch(0)
    key = jax.random.PRNGKey(7)
    trained = generator_nets(diff, joint)
    (j_g, j_aux), j_grads = j_gen_value_and_grad(phase, zoo, batch, key)
    tb = torch_batch(batch)
    with frozen(nets[n] for n in nets if n not in trained):
        g_partial, aux = stage2_forward(nets, stage2_tiny()[5], LP, tb,
                                        port_noise(key, nets, jmp, tb), MEL_LEN, STEPS, diff,
                                        joint, 0.2)
        loss_gen = (generator_adversarial_loss(nets["mpd"], nets["msd"], aux["wav_target"],
                                               aux["y_rec"]) if start_ds else torch.zeros(()))
        g_loss = g_partial + LP.lambda_gen * loss_gen
        g_loss.backward()
    np.testing.assert_allclose(float(g_loss), float(j_g), rtol=1e-5)
    assert_metrics_close(j_aux["metrics"], {**aux["metrics"], "gen_loss": loss_gen}, j_g)
    np.testing.assert_allclose(float(aux["sigma_data"]), float(j_aux["sigma_data"]), rtol=1e-5)
    assert (float(aux["metrics"]["diff_loss"]) > 0) == diff
    for name in trained:
        if name == "decoder":           # the stand-in holds no parameter
            assert all(p.grad is None for p in nets[name].parameters())
            continue
        assert_grads_close(j_grads[name], port_grads(nets[name]), rtol=1e-4, net_tol=1e-5)
    for name in STAGE2_NETS:
        if name not in trained:
            assert all(p.grad is None for p in nets[name].parameters()), name
    assert all(p.requires_grad for p in nets.parameters())


# ---------------------------------------------------------------------------
# the update order against optax
# ---------------------------------------------------------------------------

LR = {"mpd": 1e-2, "msd": 1e-2}          # the discriminators' step shows in g_loss
# (leaf, net) tolerances of the discriminators' gradients: test_torch_tma.py's
# 1e-4, and for the MSD 3e-3 of the net's largest: the tiny MSD's scores span
# ~4e-3 over 25-31k positions of a clip, so 59-1086 of them lie within 1e-6
# of the TPRLS loss's median, and the packages' ~1e-7 differences move some
# across its mask (measured 1.3e-3 of the net's largest gradient, in the
# score convs' biases; AdamW's step, lr * sign(g), is held below all the same)
GRAD_TOL = {"mpd": (1e-4, 1e-4), "msd": (1e-4, 3e-3)}
DEFAULT_LR = 1e-2


def optax_update(params, grads, state=None, lr=DEFAULT_LR):
    """One AdamW update as the JAX ``MultiOptimizer`` makes it: (params,
    state), from ``state`` or a fresh one."""
    tx = optax.adamw(lr, b1=0.0, b2=0.99, eps=1e-9, weight_decay=1e-4)
    upd, state = tx.update(grads, tx.init(params) if state is None else state, params)
    return optax.apply_updates(params, upd), state


@functools.lru_cache(maxsize=None)
def j_disc_value_and_grad():
    def disc_loss(disc, y_rec, wav):
        y = wav[:, None, :]
        return discriminator_loss_full(j_disc.mpd_apply(disc["mpd"], y, y_rec),
                                       j_disc.msd_apply(disc["msd"], y, y_rec))
    return jax.jit(jax.value_and_grad(disc_loss))


@functools.lru_cache(maxsize=None)
def j_slm_value_and_grad(run_disc, use_rec):
    _, _, jmp, jpl, jcfg, _ = stage2_tiny()
    keys = ("wd",) if run_disc else t_stage2.SLM_GENERATOR

    def slm_loss(train, frozen_params, batch, key, aux):
        out = j_slm_adversarial(
            {**frozen_params, **train}, jax.random.fold_in(key, 50), jmp, jpl, jcfg,
            JSlmAdvParams(**ADV), batch["ref_texts"], batch["ref_lengths"], batch["waves"],
            batch["mel_input_length"], aux["y_rec_gt"], aux["y_rec_gt_pred"],
            jax.lax.stop_gradient(aux["s_trg"]), None, num_steps=STEPS, use_ind_style=False,
            run_discriminator=run_disc, frame_capacity=CAPACITY,
            mel_len=min(ADV["min_len"] // 2, MEL_LEN), use_rec=use_rec, real_alt=False,
            sigma_data=aux["sigma_data"])
        return (out.d_loss if run_disc else out.gen_loss), out.valid_fraction

    def fn(train, frozen_params, batch, key, aux):
        (loss, vf), grads = jax.value_and_grad(slm_loss, has_aux=True)(
            train, frozen_params, batch, key, aux)
        if not run_disc:
            grads, _ = j_opt.clip_by_global_norm_if_above(grads, 5)
            grads = j_opt.scale_module_grads(grads, {"diffusion": 0.01})
            pg = dict(grads["predictor"])
            for sub in ("duration_proj", "lstm"):
                pg[sub] = jax.tree_util.tree_map(lambda g: g * 0.01, pg[sub])
            grads = {**grads, "predictor": pg}
        return loss, vf, grads

    return keys, jax.jit(fn)


def assert_params_moved_as(theirs, grads, nets, name, lr, tol=1e-6):
    """AdamW's first step moves each weight by lr * sign(g) (+ decay), a
    second (beta1 0, beta2 0.99) by at most ~1.42 lr: a weight whose
    gradient in either update is within rounding of 0 may move either way,
    the others as optax moves them, within ``tol``."""
    got = dict(nets[name].named_parameters())
    flat_gs = [{k: np.asarray(g) for k, g in flatten(tree).items()} for tree in grads]
    net_max = [max(float(np.abs(g).max()) for g in flat_g.values()) for flat_g in flat_gs]
    bound = {1: 2.01, 2: 4.9}[len(grads)] * lr
    for k, v in flatten(theirs).items():
        if k not in got:
            # a buffer here: the spectral-norm vectors, which optax decays in
            # the JAX package (a scale the power iteration divides out)
            continue
        settled = np.ones(np.shape(v), bool)
        for flat_g, top in zip(flat_gs, net_max):
            # within 1e-3 of its leaf's or 1e-4 of its net's largest gradient
            # (a leaf whose true gradient is 0, as an attention key's bias,
            # holds rounding noise)
            g = flat_g[k]
            settled &= np.abs(g) > max(1e-3 * float(np.abs(g).max()), 1e-4 * top)
        want = np.asarray(v)
        diff = np.abs(got[k].detach().numpy() - want)
        assert float(diff[settled].max(initial=0.0)) <= tol, f"{name}.{k}"
        assert float(diff.max()) <= bound, f"{name}.{k}"


@pytest.mark.parametrize("run_disc", [False, True])
def test_joint_step_update_order_against_optax(run_disc):
    """``Stage2Trainer.step`` of a joint step: the MPD/MSD step on the
    detached waveforms, the generator step against the updated
    discriminators, then the SLM update (generator form with the clip and
    the 0.01 scales, or the WD's with ``use_rec``) with the nets the
    generator step left.  Each update's gradients against the JAX ones,
    each loss against JAX's on the right parameters (and away from JAX's on
    the parameters before the update before it), and the nets after the
    step against optax."""
    zoo, nets, jmp, _, jcfg, mp = stage2_tiny()
    nets = copy.deepcopy(nets)
    cfg = Config(optimizer_params=OptimizerParams(lr=DEFAULT_LR, bert_lr=DEFAULT_LR,
                                                  ft_lr=DEFAULT_LR),
                 slmadv_params=SlmAdvParams(**ADV), loss_params=LP)
    opt = MultiOptimizer(nets, LR, default_lr=DEFAULT_LR)
    seen = []
    step_nets = opt.step

    def recording_step(active):
        seen.append({n: {k: None if p.grad is None else p.grad.clone()
                         for k, p in nets[n].named_parameters()} for n in active})
        step_nets(active)
    opt.step = recording_step
    trainer = Stage2Trainer(cfg, {"model": mp, "whisper": nets["slm_encoder"].cfg}, nets, opt)
    trainer.check_nets()
    batch, key = stage2_batch(1), jax.random.PRNGKey(11)
    jb = jax_batch(batch)
    trained = generator_nets(True, True)

    # JAX: the forward, the discriminators' step, the generator's, the SLM's
    (j_g_old, aux0), _ = j_gen_value_and_grad("joint", zoo, batch, key)
    d_loss, d_grads = j_disc_value_and_grad()(
        split(zoo, ("mpd", "msd"))[0], jax.lax.stop_gradient(aux0["y_rec"]),
        jax.lax.stop_gradient(aux0["wav_target"]))
    zoo1 = {**zoo, **{n: optax_update(zoo[n], d_grads[n], lr=LR[n])[0]
                      for n in ("mpd", "msd")}}
    (j_g, aux), g_grads = j_gen_value_and_grad("joint", zoo1, batch, key)
    states, zoo2 = {}, dict(zoo1)
    for n in trained:
        zoo2[n], states[n] = optax_update(zoo1[n], g_grads[n])
    keys, slm_fn = j_slm_value_and_grad(run_disc, run_disc)
    s_loss, vf, s_grads = slm_fn(*split(zoo2, keys), jb, key, aux)
    s_loss_old, _, _ = slm_fn(*split(zoo1, keys), jb, key, aux)
    zoo3 = {**zoo2, **{n: optax_update(zoo2[n], s_grads[n], states.get(n))[0] for n in keys}}

    phase = Stage2Phase(True, True, True, MEL_LEN, STEPS, slm_run_disc=run_disc,
                        slm_use_rec=run_disc, slm_frame_capacity=CAPACITY)
    tb = torch_batch(batch)
    metrics, sigma_data = trainer.step(tb, phase, 0.2, noise=port_noise(key, nets, jmp, tb))

    assert [sorted(s) for s in seen] == [["mpd", "msd"], sorted(trained), sorted(keys)]
    np.testing.assert_allclose(float(metrics["d_loss"]), float(d_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["g_loss"]), float(j_g), rtol=1e-5)
    assert abs(float(j_g) - float(j_g_old)) > 1e-3 * abs(float(j_g))
    slm_key = "d_loss_slm" if run_disc else "gen_loss_slm"
    ours, theirs, before = float(metrics[slm_key]), float(s_loss), float(s_loss_old)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    # the SLM pass saw the generator step's nets: the port's loss equals
    # JAX's on them (to the last digit, measured), and JAX's on the nets
    # before the generator step lies 9e-5 away (relative; the WD's loss, which
    # sees those nets only through the fake waveform, 1.7e-6)
    margin = 0.0 if run_disc else 2e-5 * abs(theirs)
    assert abs(ours - before) > 5 * abs(ours - theirs) + margin
    np.testing.assert_allclose(float(metrics["slm_valid_fraction"]), float(vf))
    np.testing.assert_allclose(float(sigma_data), float(aux["sigma_data"]), rtol=1e-5)
    for grads, updates in ((d_grads, seen[0]), (g_grads, seen[1]), (s_grads, seen[2])):
        for name, got in updates.items():
            if name == "decoder":       # the stand-in holds no parameter
                continue
            assert_grads_close(grads[name], got, *GRAD_TOL.get(name, (1e-4, 1e-5)))
    # the MSD's gradients carry its TPRLS mask (GRAD_TOL), which AdamW's eps
    # (1e-9) passes on where |g| nears 1e-8 (measured 1.2e-6)
    for name, tol in (("mpd", 1e-6), ("msd", 1e-5)):
        assert_params_moved_as(zoo3[name], [d_grads[name]], nets, name, LR[name], tol)
    for name in dict.fromkeys(trained + keys):
        grads = ([g_grads[name]] if name in trained else []) + (
            [s_grads[name]] if name in keys else [])
        assert_params_moved_as(zoo3[name], grads, nets, name, DEFAULT_LR)
    for name in ("text_encoder", "text_aligner", "pitch_extractor", "slm_encoder"):
        for k, v in flatten(zoo[name]).items():
            np.testing.assert_array_equal(nets[name].state_dict()[k].numpy(), np.asarray(v))
