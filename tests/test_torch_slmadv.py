"""The port's SLM adversarial pass (``losses/slmadv.py``) against the JAX
package's ``slm_adversarial`` and ``_slm_discriminator_step``, on the CPU.

The pass is split at the decoder's waveform ``y_pred``, as
``test_torch_tma.py`` splits the TMA step at ``y_rec``: both packages run
the same smooth stand-in for ``decoder_apply`` (the decoder's forward and
backward are held by ``test_torch_stage1.py``, and its STFT phases carry the
branch cut of ROADMAP.md section C).  Everything before it (PL-BERT,
``bert_encoder``, the ADPM2 sample of the style, the predictor with its
dropout, the Gaussian alignment, the clips of the predicted frames and the
recordings, the F0/N head) and after it (the Whisper encoder, the WD, the
validity weights) is compared.  The port is fed the draws the JAX pass makes
from its key.

Tolerances: losses and the WD's gradients 1e-5 relative in f32.  The
generator nets' gradients at max|diff| <= 1e-4 max|g_leaf| + 1e-5
max|g_net|: the Whisper loss's gradient to the waveform agrees at ~1e-5 of
its largest element (``test_torch_slm.py``) and the pass sums it into every
leaf, measured at up to 1.6e-5 of a leaf's largest gradient (with a pure
tone as the stand-in's carrier, whose spectrum is mostly empty bins, 8.6e-5).
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.config import SlmAdvParams as JSlmAdvParams
from styletts2_tpu.losses import slmadv as j_slmadv
from styletts2_tpu.models.decoder import istftnet as j_istftnet
from styletts2_tpu_torch.config import SlmAdvParams
from styletts2_tpu_torch.losses import slmadv as t_slmadv
from styletts2_tpu_torch.losses.slmadv import SlmAdvNoise
from styletts2_tpu_torch.train.stage1 import frozen

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_stage2_parts import (assert_grads_close, j_duration_keep,  # noqa: E402
                                     j_step_noise, port_grads, rnd, stage2_tiny, t_)

torch.set_num_threads(1)

B, L, STEPS = 3, 8, 3
MEL_LEN, CAPACITY = 16, 32          # decoder frames of the clip, the alignment's budget
ADV = dict(min_len=2 * MEL_LEN, max_len=64, sig=1.5)
MEL_LENGTHS = np.array([60, 30, 56])          # sample 1 is too short: invalid
SLM_NETS = ("bert", "bert_encoder", "predictor", "diffusion")


# a fixed broadband carrier: on a tone most spectral bins are empty, and
# there the STFT loss's and the Whisper log-mel's terms turn rounding into
# sign flips of their gradients
CARRIER = np.random.default_rng(99).standard_normal(60000).astype(np.float32)


def standin_jax(params, cfg, en, f0, n, s, **kw):
    """A smooth waveform from the decoder's inputs (B, 1, 600 T): their
    envelope on a fixed noise carrier."""
    base = (jnp.repeat(jnp.tanh(jnp.mean(en, axis=1)), 600, axis=-1)
            + 0.01 * jnp.repeat(f0, 300, axis=-1) + 0.1 * jnp.repeat(n, 300, axis=-1))
    return (0.1 * jnp.tanh(base + jnp.mean(s, axis=-1, keepdims=True))
            * jnp.asarray(CARRIER[: base.shape[-1]]))[:, None, :]


def standin_torch(m, en, f0, n, s, **kw):
    base = (torch.repeat_interleave(torch.tanh(torch.mean(en, dim=1)), 600, dim=-1)
            + 0.01 * torch.repeat_interleave(f0, 300, dim=-1)
            + 0.1 * torch.repeat_interleave(n, 300, dim=-1))
    return (0.1 * torch.tanh(base + torch.mean(s, dim=-1, keepdim=True))
            * torch.from_numpy(CARRIER[: base.shape[-1]]))[:, None, :]


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(j_istftnet, "decoder_apply", standin_jax)
    monkeypatch.setattr(t_slmadv, "decoder_apply", standin_torch)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    _, _, jmp, *_ = stage2_tiny()
    return {"ref_texts": rng.integers(4, 179, (B, L)).astype(np.int32),
            "ref_lengths": np.array([L, 5, 7], np.int32),
            "waves": rnd(rng, B, int(MEL_LENGTHS.max()) * 300, scale=0.1),
            "mel_input_length": MEL_LENGTHS.astype(np.int32),
            "y_rec_gt": rnd(rng, B, MEL_LEN * 600, scale=0.1),
            "y_rec_gt_pred": rnd(rng, B, MEL_LEN * 600, scale=0.1),
            "s_trg": rnd(rng, B, 2 * jmp.style_dim, scale=0.3)}


def jax_draws(key, jmp, b=B, length=L, steps=STEPS):
    """The port's ``SlmAdvNoise`` from the JAX pass's key, for ``b`` texts
    of ``length`` tokens and a sampler of ``steps`` steps."""
    shape = (b, 1, 2 * jmp.style_dim)
    enc, lstm = j_duration_keep(jax.random.fold_in(key, 43), jmp.n_layer, b, length,
                                jmp.hidden_dim)
    align, _ = j_duration_keep(jax.random.fold_in(key, 44), jmp.n_layer, b, length,
                               jmp.hidden_dim)
    return SlmAdvNoise(
        emb_mask=t_(jax.random.bernoulli(jax.random.fold_in(key, 40), 0.1, (b, 1, 1))),
        noise=t_(jax.random.normal(jax.random.fold_in(key, 41), shape)),
        step_noise=t_(j_step_noise(jax.random.fold_in(key, 42), steps, shape)),
        dur_encoder_keep=t_(enc), dur_lstm_keep=t_(lstm), align_encoder_keep=t_(align),
        pred_u=t_(jax.random.uniform(jax.random.fold_in(key, 45), (b,))),
        gt_u=t_(jax.random.uniform(jax.random.fold_in(key, 46), (b,))))


def run_both(use_ind, run_disc, use_rec=False, real_alt=False, seed=0):
    """The JAX pass's loss and gradients (to the SLM generator nets, or the
    WD) and the port's pass with the same draws."""
    zoo, nets, jmp, jpl, jcfg, mp = stage2_tiny()
    nets = copy.deepcopy(nets)
    x = inputs(seed)
    key = jax.random.PRNGKey(50 + seed)
    trained = ("wd",) if run_disc else SLM_NETS

    def j_loss(train):
        out = j_slmadv.slm_adversarial(
            {**zoo, **train}, key, jmp, jpl, jcfg, JSlmAdvParams(**ADV),
            *(jnp.asarray(x[k]) for k in ("ref_texts", "ref_lengths", "waves",
                                          "mel_input_length", "y_rec_gt", "y_rec_gt_pred",
                                          "s_trg")),
            None, num_steps=STEPS, use_ind_style=use_ind, run_discriminator=run_disc,
            frame_capacity=CAPACITY, mel_len=MEL_LEN, use_rec=use_rec, real_alt=real_alt,
            sigma_data=jnp.float32(0.17))
        return (out.d_loss if run_disc else out.gen_loss), out

    (j_value, j_out), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        {k: zoo[k] for k in trained})
    with frozen(nets[n] for n in nets if n not in trained):
        out = t_slmadv.slm_adversarial(
            nets, mp, SlmAdvParams(**ADV), t_(x["ref_texts"]).long(),
            t_(x["ref_lengths"]).long(), t_(x["waves"]), t_(x["mel_input_length"]).long(),
            t_(x["y_rec_gt"]), t_(x["y_rec_gt_pred"]), t_(x["s_trg"]), jax_draws(key, jmp),
            STEPS, use_ind, run_disc, CAPACITY, mel_len=MEL_LEN, use_rec=use_rec,
            real_alt=real_alt, sigma_data=torch.tensor(0.17))
        value = out.d_loss if run_disc else out.gen_loss
        value.backward()
    return (float(j_value), j_out, j_g), (value, out, nets)


@pytest.mark.parametrize("use_ind", [False, True])
def test_slm_adversarial_generator_loss_and_gradients(standin, use_ind):
    """The generator loss (sample 1 invalid: weights [1, 0, 1]) and its
    gradients to ``bert``, ``bert_encoder``, ``predictor`` and ``diffusion``
    (none to the diffusion with the ground-truth style)."""
    (j_value, j_out, j_g), (value, out, nets) = run_both(use_ind, False)
    np.testing.assert_allclose(float(value), j_value, rtol=1e-5)
    np.testing.assert_allclose(float(out.valid_fraction), float(j_out.valid_fraction))
    assert abs(float(out.valid_fraction) - 2 / 3) < 1e-6 and float(out.d_loss) == 0.0
    for name in SLM_NETS:
        if use_ind and name == "diffusion":
            assert all(p.grad is None for p in nets[name].parameters())
            assert not any(np.asarray(g).any() for g in jax.tree_util.tree_leaves(j_g[name]))
            continue
        assert_grads_close(j_g[name], port_grads(nets[name]), rtol=1e-4, net_tol=1e-5)
    for name in ("wd", "slm_encoder", "text_encoder", "decoder"):
        assert all(p.grad is None for p in nets[name].parameters()), name


def test_slm_adversarial_discriminator_pass(standin):
    """With ``run_discriminator`` the generator side runs with no graph
    and the WD's loss (with both regularisers) takes gradients to the WD
    alone."""
    (j_value, _, j_g), (value, out, nets) = run_both(True, True, use_rec=True, real_alt=True,
                                                     seed=1)
    np.testing.assert_allclose(float(value), j_value, rtol=1e-5)
    assert float(out.gen_loss) == 0.0
    assert_grads_close(j_g["wd"], port_grads(nets["wd"]))
    for name in SLM_NETS:
        assert all(p.grad is None for p in nets[name].parameters()), name


@pytest.mark.parametrize("longer", ["real", "fake"])
@pytest.mark.parametrize("use_rec,real_alt", [(False, False), (False, True), (True, False),
                                              (True, True)])
def test_slm_discriminator_step_branches(use_rec, real_alt, longer):
    """``slm_discriminator_step`` against the JAX ``_slm_discriminator_step``
    in every static branch: the reconstruction as the real side or not, the
    cropped one in the LSGAN term or not, the real side longer than the
    fake or not (``run_stage2`` gives equal lengths, the second form)."""
    zoo, nets, jmp, _, jcfg, mp = stage2_tiny()
    nets = copy.deepcopy(nets)
    rng = np.random.default_rng(3)
    t_rec, t_p = (5400, 4800) if longer == "real" else (4800, 5400)
    wav, y_pred = rnd(rng, B, 4800, scale=0.1), rnd(rng, B, t_p, scale=0.1)
    y_rec_gt, y_rec_gt_pred = rnd(rng, B, t_rec, scale=0.1), rnd(rng, B, t_rec, scale=0.1)
    weights = np.array([1.0, 0.0, 1.0], np.float32)

    def j_loss(wd):
        return j_slmadv._slm_discriminator_step(
            {**zoo, "wd": wd}, jcfg, jmp, jnp.asarray(wav), jnp.asarray(y_pred),
            jnp.asarray(y_rec_gt), jnp.asarray(y_rec_gt_pred), jnp.asarray(weights),
            jnp.float32(1.0), use_rec, real_alt)

    j_value, j_g = jax.jit(jax.value_and_grad(j_loss))(zoo["wd"])
    with frozen([nets["slm_encoder"]]):
        loss = t_slmadv.slm_discriminator_step(
            nets, mp.slm.hop_length, t_(wav), t_(y_pred), t_(y_rec_gt), t_(y_rec_gt_pred),
            t_(weights), torch.tensor(1.0), use_rec, real_alt)
        loss.backward()
    np.testing.assert_allclose(float(loss), float(j_value), rtol=1e-5)
    assert_grads_close(j_g, port_grads(nets["wd"]))
    assert all(p.grad is None for p in nets["slm_encoder"].parameters())
