"""The port's stage-1 TMA phase against JAX compositions, on the CPU.

The step is split at the decoder's waveform ``y_rec``: the forward before
it is held by ``test_torch_stage1.py``.  Here:
- the TMA loss terms (s2s, mono, the MPD/MSD generator losses, the Whisper
  feature loss) and ``g_loss`` with its gradients to ``y_rec``,
  ``s2s_attn`` and ``s2s_pred``, against the lines of the JAX
  ``Stage1Trainer``'s ``gen_loss_fn`` (``styletts2_tpu/train/stage1.py``
  206-230) written over the JAX package's functions and jitted;
- the aligner's and the pitch extractor's parameter gradients, which the
  TMA phase trains;
- the update order: the discriminator step's AdamW against optax, then
  ``g_loss`` and its gradient under the updated MPD/MSD;
- ``run_stage1`` across ``TMA_epoch`` on the CPU.
The JAX ``Stage1Trainer.make_step`` is not compiled: minutes on a CPU.
Tiny nets; tolerance 1e-5 relative in f32 unless noted.
"""

import copy
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from styletts2_tpu.audio.mel import DATASET_MEL, log_mel_spectrogram
from styletts2_tpu.losses.gan import discriminator_loss_full, generator_loss_full
from styletts2_tpu.losses.slm import slm_feature_loss
from styletts2_tpu.models import discriminators as j_disc
from styletts2_tpu.models.jdc import jdc_apply as j_jdc_apply
from styletts2_tpu.train.stage1 import compute_alignment as j_compute_alignment
from styletts2_tpu_torch.config import Config, OptimizerParams
from styletts2_tpu_torch.models.jdc import jdc_apply
from styletts2_tpu_torch.models.zoo import STAGE1_TMA_NETS, flatten
from styletts2_tpu_torch.train.loop import make_lr_map, run_stage1
from styletts2_tpu_torch.train.optimizers import MultiOptimizer
from styletts2_tpu_torch.train.stage1 import (DISCRIMINATORS, TMA_TRAINED, Stage1Trainer,
                                              compute_alignment, frozen, mono_loss, s2s_loss,
                                              tma_generator_loss)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_aux import J_ASR, J_JDC, stage1_tiny  # noqa: E402
from test_torch_gan import tiny_discriminators  # noqa: E402
from test_torch_slm import tiny_encoder  # noqa: E402
from test_torch_stage1 import make_batch  # noqa: E402

torch.set_num_threads(1)

B, T_TEXT, L, N_TOKEN, T_WAV = 2, 6, 8, 179, 4800
LP = Config().loss_params


@pytest.fixture(autouse=True, scope="module")
def plain_msd():
    j_disc.set_spec_conv_impl("plain")
    yield
    j_disc.set_spec_conv_impl("auto")


def tma_nets():
    """The tiny stage-1 nets with the tiny MPD, MSD and Whisper encoder, and
    the JAX trees of the last three."""
    _, nets, *_ = stage1_tiny()
    disc_tree, disc = tiny_discriminators()
    slm_tree, jcfg, enc = tiny_encoder()
    nets = copy.deepcopy(nets)
    nets.update({"mpd": copy.deepcopy(disc["mpd"]), "msd": copy.deepcopy(disc["msd"]),
                 "slm_encoder": copy.deepcopy(enc)})
    return nets, {**disc_tree, "slm_encoder": slm_tree}, jcfg


def leaves(seed=0):
    """The forward's outputs the TMA losses read, as numpy."""
    rng = np.random.default_rng(seed)
    attn = rng.random((B, T_TEXT, L)).astype(np.float32)
    mono = np.zeros((B, T_TEXT, L), np.float32)
    mono[:, np.minimum(np.arange(L) * T_TEXT // L, T_TEXT - 1), np.arange(L)] = 1.0
    return {"y_rec": (0.1 * rng.standard_normal((B, 1, T_WAV))).astype(np.float32),
            "wav": (0.1 * rng.standard_normal((B, T_WAV))).astype(np.float32),
            "s2s_pred": rng.standard_normal((B, T_TEXT + 1, N_TOKEN)).astype(np.float32),
            "s2s_attn": attn, "s2s_attn_mono": mono,
            "texts": rng.integers(4, N_TOKEN, (B, T_TEXT)).astype(np.int32),
            "text_lengths": np.array([T_TEXT, 4], np.int32)}


@functools.lru_cache(maxsize=None)
def j_gen_loss_fn(jcfg):
    """The JAX TMA generator loss from the leaves (stage1.py:206-230), with
    the MPD/MSD and Whisper trees as arguments: (g_loss, metrics) and the
    gradients to y_rec, s2s_attn and s2s_pred."""
    def loss(diff, fixed, trees, loss_mel):
        y_rec, s2s_pred, s2s_attn = diff
        wav = fixed["wav"]
        logits = s2s_pred[:, :-1, :].astype(jnp.float32)
        tmask = (jnp.arange(logits.shape[1])[None, :] <
                 fixed["text_lengths"][:, None]).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, fixed["texts"][..., None], axis=-1)[..., 0]
        loss_s2s = jnp.mean((nll * tmask).sum(1) / jnp.maximum(tmask.sum(1), 1))
        loss_mono = jnp.mean(jnp.abs(s2s_attn - fixed["s2s_attn_mono"])) * 10.0
        y = wav[:, None, :]
        loss_gen = generator_loss_full(
            j_disc.mpd_apply(trees["mpd"], y, y_rec, batched=False),
            j_disc.msd_apply(trees["msd"], y, y_rec, batched=False))
        loss_slm = slm_feature_loss(trees["slm_encoder"], wav, y_rec[:, 0, :], jcfg, 300)
        g_loss = (LP.lambda_mel * loss_mel + LP.lambda_mono * loss_mono
                  + LP.lambda_s2s * loss_s2s + LP.lambda_gen * loss_gen
                  + LP.lambda_slm * loss_slm)
        return g_loss, {"gen_loss": loss_gen, "mono_loss": loss_mono, "s2s_loss": loss_s2s,
                        "slm_loss": loss_slm}

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def port_aux(lv):
    aux = {k: torch.from_numpy(v) for k, v in lv.items()}
    for k in ("texts", "text_lengths"):
        aux[k] = aux[k].long()
    for k in ("y_rec", "s2s_pred", "s2s_attn"):
        aux[k].requires_grad_()
    aux["mel_loss"] = torch.tensor(0.75)
    return aux


def jax_args(lv, trees):
    diff = tuple(jnp.asarray(lv[k]) for k in ("y_rec", "s2s_pred", "s2s_attn"))
    fixed = {k: jnp.asarray(lv[k]) for k in ("wav", "s2s_attn_mono", "texts", "text_lengths")}
    return diff, fixed, trees, jnp.float32(0.75)


def assert_grads_close(aux, j_grads, tol=1e-5):
    for k, g in zip(("y_rec", "s2s_pred", "s2s_attn"), j_grads):
        g = np.asarray(g)
        err = float(np.abs(aux[k].grad.numpy() - g).max())
        assert err <= tol * float(np.abs(g).max()), (k, err)


@pytest.mark.parametrize("remat", [True, False])
def test_tma_loss_terms_and_gradients(remat):
    nets, trees, jcfg = tma_nets()
    lv = leaves(0)
    (j_g, j_metrics), j_grads = j_gen_loss_fn(jcfg)(*jax_args(lv, trees))
    aux = port_aux(lv)
    with frozen(nets[n] for n in ("mpd", "msd", "slm_encoder")):
        g_loss, metrics = tma_generator_loss(nets, LP, aux["mel_loss"], aux, 300, remat)
        g_loss.backward()
    np.testing.assert_allclose(float(g_loss), float(j_g), rtol=1e-5)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    assert_grads_close(aux, j_grads)
    assert all(p.grad is None for n in ("mpd", "msd", "slm_encoder")
               for p in nets[n].parameters())
    assert all(p.requires_grad for p in nets.parameters())


def test_aligner_and_pitch_extractor_gradients():
    """With TMA the aligner trains through the mono and s2s losses and the
    pitch extractor through F0: their parameter gradients against JAX (the
    JAX pitch extractor's batch-norm statistics aside)."""
    zoo, nets, *_ = stage1_tiny()
    nets = copy.deepcopy(nets)
    batch = make_batch(0)
    mels = log_mel_spectrogram(jnp.asarray(batch["waves"]), DATASET_MEL)
    mels = np.asarray(mels[..., : (mels.shape[-1] // 2) * 2])
    ml = batch["mel_input_length"]
    texts, tl = batch["texts"], batch["input_lengths"]
    gt = mels[:, :, 10:90]
    cot = np.random.default_rng(6).standard_normal((2, 80)).astype(np.float32)

    def j_losses(p):
        _, s2s_pred, s2s_attn, mono = j_compute_alignment(
            {"text_aligner": p["text_aligner"]}, jnp.asarray(mels), jnp.asarray(ml, jnp.int32),
            jnp.asarray(texts, jnp.int32), jnp.asarray(tl, jnp.int32), J_ASR, train=False,
            rng=None)
        logits = s2s_pred[:, :-1, :]
        tmask = (jnp.arange(logits.shape[1])[None, :] < jnp.asarray(tl)[:, None]).astype(
            jnp.float32)
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, -1),
                                   jnp.asarray(texts)[..., None], axis=-1)[..., 0]
        s2s = jnp.mean((nll * tmask).sum(1) / jnp.maximum(tmask.sum(1), 1))
        f0, _, _ = j_jdc_apply(p["pitch_extractor"], jnp.asarray(gt)[:, None], J_JDC)
        return (10.0 * jnp.mean(jnp.abs(s2s_attn - mono)) + s2s
                + jnp.sum(f0 * jnp.asarray(cot)))

    want = jax.jit(jax.grad(j_losses))({k: zoo[k] for k in ("text_aligner", "pitch_extractor")})
    _, s2s_pred, s2s_attn, mono = compute_alignment(
        nets["text_aligner"], torch.from_numpy(mels), torch.from_numpy(ml).long(),
        torch.from_numpy(texts).long(), torch.from_numpy(tl).long())
    f0, _, _ = jdc_apply(nets["pitch_extractor"], torch.from_numpy(gt)[:, None])
    loss = (mono_loss(s2s_attn, mono)
            + s2s_loss(s2s_pred, torch.from_numpy(texts).long(), torch.from_numpy(tl).long())
            + (f0 * torch.from_numpy(cot)).sum())
    loss.backward()
    # The pitch extractor's frequency max-pools hold dozens of windows whose
    # two largest bins lie within 1e-5 of each other on this input: the
    # packages' ~1e-6 forward differences move such an argmax, and its
    # gradient with it (measured up to 4.8e-5 of the net's largest gradient,
    # 1.8e-3 of the leaf's, in the layers before the pools).
    net_tol = {"text_aligner": 1e-5, "pitch_extractor": 1e-4}
    for name in ("text_aligner", "pitch_extractor"):
        flat = {k: np.asarray(g) for k, g in flatten(want[name]).items()}
        got = {k: p.grad for k, p in nets[name].named_parameters()}
        net_max = max(float(np.abs(g).max()) for g in flat.values())
        assert net_max > 0
        for k, g in flat.items():
            if k.endswith(("running_mean", "running_var")):
                # JAX differentiates its eval-mode batch norm's statistics
                # too, and its optax step moves them; here, as in the
                # reference, they are buffers and take no update
                assert k not in got
                continue
            if got[k] is None:                    # outside the loss (the CTC head)
                assert not g.any(), f"{name}.{k}"
                continue
            err = float(np.abs(got[k].numpy() - g).max())
            assert err <= 1e-4 * float(np.abs(g).max()) + net_tol[name] * net_max, (
                f"{name}.{k}", err)


def test_discriminator_step_then_generator_against_optax():
    """``tma_update``: the discriminator step's loss and AdamW update
    against optax on the JAX gradients, then ``g_loss`` and its gradients
    under the updated MPD/MSD (which differ from those under the old ones
    by far more than the tolerance)."""
    nets, trees, jcfg = tma_nets()
    lr = 1e-2
    cfg = Config(optimizer_params=OptimizerParams(lr=lr))
    opt = MultiOptimizer(nets, make_lr_map(cfg), default_lr=lr)
    trainer = Stage1Trainer(cfg, {"model": stage1_tiny()[3], "whisper": nets["slm_encoder"].cfg},
                            nets, opt)
    lv = leaves(1)

    def j_d_loss(disc):
        y = jnp.asarray(lv["wav"])[:, None, :]
        y_hat = jnp.asarray(lv["y_rec"])
        return discriminator_loss_full(j_disc.mpd_apply(disc["mpd"], y, y_hat),
                                       j_disc.msd_apply(disc["msd"], y, y_hat))

    disc = {k: trees[k] for k in DISCRIMINATORS}
    d_loss, d_grads = jax.jit(jax.value_and_grad(j_d_loss))(disc)
    tx = optax.adamw(lr, b1=0.0, b2=0.99, eps=1e-9, weight_decay=1e-4)
    upd, _ = tx.update(d_grads, tx.init(disc), disc)
    new_disc = optax.apply_updates(disc, upd)
    fn = j_gen_loss_fn(jcfg)
    (j_g, _), j_grads = fn(*jax_args(lv, {**trees, **new_disc}))
    (j_g_old, _), _ = fn(*jax_args(lv, trees))

    aux = port_aux(lv)
    metrics = trainer.tma_update(aux["mel_loss"], aux)
    np.testing.assert_allclose(float(metrics["d_loss"]), float(d_loss), rtol=1e-5)
    for name in DISCRIMINATORS:
        got = dict(nets[name].named_parameters())
        for k, v in flatten(new_disc[name]).items():
            g = np.asarray(flatten(d_grads[name])[k])
            # AdamW's first step moves each weight by lr * sign(g): a weight
            # whose gradient is within rounding of 0 may move either way
            settled = np.abs(g) > 1e-3 * np.abs(g).max()
            diff = np.abs(got[k].detach().numpy() - np.asarray(v))
            assert float(diff[settled].max(initial=0.0)) <= 1e-6, f"{name}.{k}"
            assert float(diff.max()) <= 2.01 * lr, f"{name}.{k}"
    np.testing.assert_allclose(float(metrics["g_loss"]), float(j_g), rtol=1e-5)
    assert abs(float(j_g) - float(j_g_old)) > 1e-3 * abs(float(j_g))
    assert_grads_close(aux, j_grads)
    assert all(p.requires_grad for p in nets.parameters())


def test_run_stage1_crosses_tma_epoch_on_cpu():
    """One step before TMA and one after through the driver: finite losses
    (``d_loss`` too), the TMA step's gradients reach the aligner and the
    pitch extractor, the seven trained nets move and the Whisper encoder
    does not."""
    nets, _, _ = tma_nets()
    _, _, _, mp, _, _ = stage1_tiny()
    before = {k: copy.deepcopy(v.state_dict()) for k, v in nets.items()}
    logs = []
    cfg = Config(log_interval=1, max_len=80,
                 loss_params=dataclasses.replace(LP, TMA_epoch=1))
    state = run_stage1(cfg, {"model": mp, "whisper": nets["slm_encoder"].cfg}, nets,
                       lambda epoch: iter([make_batch(epoch)]), max_steps=2,
                       log_cb=lambda it, m: logs.append(m), device="cpu", seed=0)
    assert state.iters == 2 and len(logs) == 2
    assert set(logs[0]) == {"mel_loss", "g_loss"}
    assert set(logs[1]) == {"mel_loss", "gen_loss", "mono_loss", "s2s_loss", "slm_loss",
                            "g_loss", "d_loss"}
    assert all(np.isfinite(v) for m in logs for v in m.values())
    for name in TMA_TRAINED:
        assert any(p.grad is not None and bool(p.grad.any())
                   for p in nets[name].parameters()), name
    assert all(p.grad is None for p in nets["slm_encoder"].parameters())
    for name in STAGE1_TMA_NETS:
        moved = any(not torch.equal(v, before[name][k])
                    for k, v in nets[name].state_dict().items())
        assert moved == (name != "slm_encoder"), name
    with pytest.raises(ValueError, match="slm_encoder"):
        Stage1Trainer(cfg, {"model": mp}, nets, state.optimizer).make_step(True, 40, 40)
