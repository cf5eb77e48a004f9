"""The port's stage-2 parts against the JAX package's, on the CPU:
``gaussian_alignment`` (values and gradients), the predictor's training
forms (``prosody_duration_apply`` and ``prosody_f0n_apply`` with the JAX
package's dropout masks fed in), ``k_diffusion_loss`` with its sigmas and
noise, the Whisper discriminator and the three SLM adversarial losses with
sample weights, and the SLM update's gradient clip and scale.

``stage2_tiny`` builds the tiny 14-net zoo the stage-2 test files share:
the tiny stage-1 nets (``test_torch_aux.stage1_tiny``), the tiny inference
nets' PL-BERT, ``bert_encoder``, predictor and diffusion
(``test_torch_models.tiny``), the tiny MPD/MSD and Whisper encoder, a tiny
Whisper discriminator, and the prosody style encoder as a copy of the style
encoder (as ``train_stage2`` starts it).  Tolerance 1e-5 relative in f32.
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

from styletts2_tpu.losses import slm as j_slm
from styletts2_tpu.models import discriminators as j_disc
from styletts2_tpu.models import predictor as j_predictor
from styletts2_tpu.models.diffusion import denoiser as j_denoiser
from styletts2_tpu.models.diffusion import sampler as j_sampler
from styletts2_tpu.ops import alignment as j_alignment
from styletts2_tpu.train import optimizers as j_opt
from styletts2_tpu.utils import materialize_params
from styletts2_tpu_torch.config import SlmConfig
from styletts2_tpu_torch.losses import slm as t_slm
from styletts2_tpu_torch.models import discriminators as t_disc
from styletts2_tpu_torch.models import predictor as t_predictor
from styletts2_tpu_torch.models.diffusion import denoiser as t_denoiser
from styletts2_tpu_torch.models.diffusion import sampler as t_sampler
from styletts2_tpu_torch.models.zoo import STAGE2_NETS, build_nets, flatten, load_jax_params
from styletts2_tpu_torch.ops import alignment as t_alignment
from styletts2_tpu_torch.train.optimizers import (clip_by_global_norm_if_above,
                                                  global_grad_norm, scale_module_grads)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_aux import stage1_tiny  # noqa: E402
from test_torch_gan import MPD_CH, MSD_W, tiny_discriminators  # noqa: E402
from test_torch_models import tiny  # noqa: E402
from test_torch_slm import tiny_encoder  # noqa: E402

torch.set_num_threads(1)

WD = dict(slm_hidden=16, slm_layers=3, initial_channel=4)   # the tiny Whisper's 3 states


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(theirs, ours, rtol=1e-5, atol=1e-6):
    """|ours - theirs| <= rtol |theirs| + atol max|theirs|, elementwise."""
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    np.testing.assert_allclose(ours, theirs, rtol=rtol,
                               atol=atol * max(float(np.abs(theirs).max()), 1e-30))


def assert_grads_close(theirs, ours, rtol=1e-5, net_tol=1e-6, skip=()):
    """Each leaf of a JAX gradient tree against the port's ``.grad`` of the
    same name: max|diff| <= rtol max|g_leaf| + net_tol max|g_net| (the
    second term for leaves whose true gradient is ~0); a parameter the
    port's graph does not reach must have a zero JAX gradient."""
    flat = {k: np.asarray(g) for k, g in flatten(theirs).items() if not k.startswith(skip)}
    net_max = max(float(np.abs(g).max()) for g in flat.values())
    assert net_max > 0
    for k, g in flat.items():
        got = ours.get(k)
        if got is None:                 # outside the graph, or a buffer (the SN vectors)
            assert not g.any(), k
            continue
        err = float(np.abs(got.detach().numpy() - g).max())
        tol = rtol * float(np.abs(g).max()) + net_tol * net_max
        assert err <= tol, (k, err, tol)


def port_grads(module):
    return {k: p.grad for k, p in module.named_parameters()}


@functools.lru_cache(maxsize=None)
def stage2_tiny():
    """(JAX tree of the 14 nets as numpy, the port's nets with it loaded,
    JAX ModelParams, JAX PLBertConfig, JAX WhisperConfig, port
    ModelParams)."""
    s1_zoo, _, jmp, _, asr, jdc = stage1_tiny()
    m_zoo, _, _, jpl, mp, pl = tiny()
    disc_tree, _ = tiny_discriminators()
    slm_tree, jcfg, enc = tiny_encoder()
    wd_tree = jax.tree_util.tree_map(np.asarray, materialize_params(jax.eval_shape(
        lambda k: j_disc.init_whisper_discriminator(k, **WD), jax.random.PRNGKey(0)), seed=7))
    zoo = {**{k: s1_zoo[k] for k in ("text_encoder", "style_encoder", "decoder",
                                     "text_aligner", "pitch_extractor")},
           **{k: m_zoo[k] for k in ("bert", "bert_encoder", "predictor", "diffusion")},
           "predictor_encoder": copy.deepcopy(s1_zoo["style_encoder"]), **disc_tree,
           "slm_encoder": slm_tree, "wd": wd_tree}
    mp = dataclasses.replace(mp, slm=SlmConfig(hidden=16, nlayers=3, initial_channel=4))
    assert mp.slm.hidden == jmp.slm.hidden and mp.slm.nlayers == jmp.slm.nlayers
    nets = load_jax_params(build_nets(mp, pl, decoder_width=64, decoder_asr_res_ch=8,
                                      nets=STAGE2_NETS, asr_cfg=asr, jdc_cfg=jdc,
                                      whisper_cfg=enc.cfg, mpd_channels=MPD_CH,
                                      msd_width=MSD_W), zoo)
    return zoo, nets, jmp, jpl, jcfg, mp


# ---------------------------------------------------------------------------
# JAX's draws, for the port's explicit noise
# ---------------------------------------------------------------------------

def j_keep(key, p, shape):
    return np.asarray(jax.random.bernoulli(key, 1.0 - p, shape))


def j_duration_keep(rng, nlayers, b, t, d_hid):
    """The dropout masks ``prosody_duration_apply(train=True, rng=rng)``
    draws: the duration encoder's per layer and the head's."""
    enc = np.stack([j_keep(jax.random.fold_in(rng, i), 0.1, (b, t, d_hid))
                    for i in range(nlayers)])
    return enc, j_keep(jax.random.fold_in(rng, 101), 0.5, (b, t, d_hid))


def j_f0n_keep(rng, shapes):
    """The dropout masks ``prosody_f0n_apply(train=True, rng=rng)`` draws,
    in the port's order (F0's blocks, then N's)."""
    out = []
    for j, (s1, s2) in enumerate(shapes):
        r = jax.random.fold_in(rng, (1 + j // 3) * 10 + j % 3)
        out.append((j_keep(jax.random.fold_in(r, 1), 0.1, s1),
                    j_keep(jax.random.fold_in(r, 2), 0.1, s2)))
    return out


def j_step_noise(key, steps, shape):
    """The per-step noise of the JAX ``adpm2_sample(key, ...)``."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                     for i in range(steps - 1)])


# ---------------------------------------------------------------------------
# gaussian_alignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_gaussian_alignment_values_and_gradients(scale):
    """The soft alignment, its frame counts and the gradient to the
    logits through a fixed cotangent; tokens past a length are masked."""
    rng = np.random.default_rng(int(scale))
    b, t_text, k, t_mel = 2, 7, 10, 60
    logits = rnd(rng, b, t_text, k, scale=scale)
    lengths = np.array([7, 4], np.int32)
    cot = rnd(rng, b, t_text, t_mel)

    def j_fn(x):
        attn, frames = j_alignment.gaussian_alignment(x, jnp.asarray(lengths), t_mel, 1.5)
        return jnp.sum(attn * cot), (attn, frames)

    (_, (j_attn, j_frames)), j_g = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
        jnp.asarray(logits))
    x = t_(logits).requires_grad_()
    attn, frames = t_alignment.gaussian_alignment(x, t_(lengths).long(), t_mel, 1.5)
    (attn * t_(cot)).sum().backward()
    np.testing.assert_array_equal(frames.numpy(), np.asarray(j_frames))
    assert frames.dtype == torch.int32 and int(frames.max()) < t_mel
    close(j_attn, attn)
    close(j_g, x.grad)
    assert not attn[1, 4:].any()


# ---------------------------------------------------------------------------
# the predictor in training form
# ---------------------------------------------------------------------------

def test_prosody_duration_and_f0n_with_jax_dropout():
    """``prosody_duration_apply`` and ``prosody_f0n_apply`` in training form
    with the masks JAX draws, their outputs and the predictor's parameter
    gradients through fixed cotangents."""
    zoo, nets, jmp, *_ = stage2_tiny()
    jp, tp = zoo["predictor"], copy.deepcopy(nets["predictor"])
    rng = np.random.default_rng(4)
    b, t, hid, sty, t_mel = 2, 9, jmp.hidden_dim, jmp.style_dim, 16
    d_en, s = rnd(rng, b, hid, t), rnd(rng, b, sty, scale=0.3)
    lengths = np.array([9, 6], np.int32)
    aln = np.zeros((b, t, t_mel), np.float32)
    aln[:, np.minimum(np.arange(t_mel) * t // t_mel, t - 1), np.arange(t_mel)] = 1.0
    key_d, key_f = jax.random.PRNGKey(24), jax.random.PRNGKey(27)
    cots = [rnd(rng, b, t, jmp.max_dur), rnd(rng, b, hid + sty, t_mel),
            rnd(rng, b, 2 * t_mel), rnd(rng, b, 2 * t_mel)]

    def j_fn(p):
        dur, en = j_predictor.prosody_duration_apply(
            p, jnp.asarray(d_en), jnp.asarray(s), jnp.asarray(lengths), jnp.asarray(aln),
            jmp.n_layer, train=True, rng=key_d)
        f0, n = j_predictor.prosody_f0n_apply(p, en, jnp.asarray(s), train=True, rng=key_f)
        outs = (dur, en, f0, n)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, j_outs), j_g = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(jp)
    enc, lstm = j_duration_keep(key_d, jmp.n_layer, b, t, hid)
    assert (enc.shape, lstm.shape) == t_predictor.duration_dropout_shapes(tp, b, t)
    f0n = j_f0n_keep(key_f, t_predictor.f0n_dropout_shapes(tp, b, t_mel))
    dur, en = t_predictor.prosody_duration_apply(tp, t_(d_en), t_(s), t_(lengths).long(),
                                                 t_(aln), t_(enc), t_(lstm))
    f0, n = t_predictor.prosody_f0n_apply(tp, en, t_(s),
                                          dropout_keep=[(t_(a), t_(c)) for a, c in f0n])
    outs = (dur, en, f0, n)
    sum((o * t_(c)).sum() for o, c in zip(outs, cots)).backward()
    for theirs, ours in zip(j_outs, outs):
        close(theirs, ours)
    assert_grads_close(j_g, port_grads(tp))
    # the eval form is unchanged: no masks, the engine's duration head
    with torch.no_grad():
        d = t_predictor.duration_encoder_apply(tp.text_encoder, t_(d_en), t_(s),
                                               t_(lengths).long())
        close(j_predictor.prosody_duration_apply(jp, jnp.asarray(d_en), jnp.asarray(s),
                                                 jnp.asarray(lengths), jnp.asarray(aln),
                                                 jmp.n_layer)[0],
              t_predictor.duration_logits(tp, d, t_(lengths).long()))


# ---------------------------------------------------------------------------
# the diffusion loss
# ---------------------------------------------------------------------------

def test_k_diffusion_loss_with_jax_sigmas_and_noise():
    """The EDM loss with the sigmas' normals and the noise JAX draws from
    its key, a batch estimate of sigma_data (population std), the fixed
    embedding for one sample; the loss and the denoiser's gradients."""
    zoo, nets, jmp, jpl, *_ = stage2_tiny()
    tr_j = zoo["diffusion"]["transformer"]
    tr_t = copy.deepcopy(nets["diffusion"]["transformer"])
    rng = np.random.default_rng(5)
    b, c, length = 3, 2 * jmp.style_dim, 9
    x = rnd(rng, b, 1, c, scale=0.3)
    emb = rnd(rng, b, length, jpl.hidden_size)
    mask = np.array([False, True, False])[:, None, None]
    key = jax.random.PRNGKey(21)
    heads = jmp.diffusion.transformer.num_heads

    def j_fn(p):
        sigma_data = jnp.mean(jnp.std(jnp.asarray(x)[:, 0], axis=-1))
        e = jnp.where(mask, j_denoiser.fixed_embedding(p, b, length), jnp.asarray(emb))
        return j_sampler.k_diffusion_loss(
            key, lambda xx, cn: j_denoiser.denoiser_apply(p, xx, cn, e, num_heads=heads),
            jnp.asarray(x), sigma_data, -3.0, 1.0)

    j_loss, j_g = jax.jit(jax.value_and_grad(j_fn))(tr_j)
    k_sig, k_noise = jax.random.split(key)
    normals = np.asarray(jax.random.normal(k_sig, (b,)))
    noise = np.asarray(jax.random.normal(k_noise, (b, 1, c)))
    sigma_data = torch.mean(torch.std(t_(x)[:, 0], dim=-1, correction=0))
    e = torch.where(t_(mask), t_denoiser.fixed_embedding(tr_t, b, length), t_(emb))
    loss = t_sampler.k_diffusion_loss(
        lambda xx, cn: t_denoiser.denoiser_apply(tr_t, xx, cn, e), t_(x), sigma_data,
        t_(normals), t_(noise), -3.0, 1.0)
    loss.backward()
    close(t_sampler.log_normal_sigmas(t_(normals)),
          j_sampler.log_normal_sigmas(k_sig, b))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert_grads_close(j_g, port_grads(tr_t))


# ---------------------------------------------------------------------------
# the Whisper discriminator and the SLM adversarial losses
# ---------------------------------------------------------------------------

def test_whisper_discriminator_keys_and_scores():
    zoo, nets, *_ = stage2_tiny()
    want = {k: np.shape(v) for k, v in flatten(zoo["wd"]).items()}
    got = {k: tuple(v.shape) for k, v in nets["wd"].state_dict().items()}
    assert got == want
    assert sorted({k.split(".")[0] for k in got}) == ["conv_post", "convs", "pre"]
    feats = rnd(np.random.default_rng(6), 2, WD["slm_hidden"] * WD["slm_layers"], 23)
    with torch.no_grad():
        close(j_disc.whisper_discriminator_apply(zoo["wd"], jnp.asarray(feats)),
              t_disc.whisper_discriminator_apply(nets["wd"], t_(feats)))


@pytest.mark.parametrize("weights", [None, (1.0, 0.0, 1.0)])
def test_slm_adversarial_losses(weights):
    """``slm_generator_loss`` with its gradient to the waveform,
    ``slm_discriminator_loss`` (real and fake of different lengths: the
    longer sets the frames) and ``slm_discriminator_forward`` with their
    gradients to the WD; optional sample weights."""
    zoo, nets, _, _, jcfg, _ = stage2_tiny()
    enc, wd = nets["slm_encoder"], copy.deepcopy(nets["wd"])
    rng = np.random.default_rng(7)
    y, wav = rnd(rng, 3, 4800, scale=0.1), rnd(rng, 3, 5400, scale=0.1)
    w_j = None if weights is None else jnp.asarray(weights, jnp.float32)
    w_t = None if weights is None else torch.tensor(weights)
    trees = {"slm_encoder": zoo["slm_encoder"], "wd": zoo["wd"]}

    def j_gen(yy):
        return j_slm.slm_generator_loss(trees["slm_encoder"], trees["wd"], yy, jcfg, 300,
                                        sample_weights=w_j)

    def j_disc_losses(wd_tree):
        d = j_slm.slm_discriminator_loss(trees["slm_encoder"], wd_tree, jnp.asarray(wav),
                                         jnp.asarray(y), jcfg, 300, sample_weights=w_j)
        f = j_slm.slm_discriminator_forward(trees["slm_encoder"], wd_tree, jnp.asarray(wav),
                                            jcfg, 300)
        return d + jnp.mean(f ** 2), (d, f)

    g_loss, g_y = jax.jit(jax.value_and_grad(j_gen))(jnp.asarray(y))
    (_, (d_loss, fwd)), g_wd = jax.jit(jax.value_and_grad(j_disc_losses, has_aux=True))(
        trees["wd"])

    yt = t_(y).requires_grad_()
    for p in enc.parameters():
        p.requires_grad_(False)
    try:
        loss = t_slm.slm_generator_loss(enc, nets["wd"], yt, 300, sample_weights=w_t)
        loss.backward()
        d = t_slm.slm_discriminator_loss(enc, wd, t_(wav), t_(y), 300, sample_weights=w_t)
        f = t_slm.slm_discriminator_forward(enc, wd, t_(wav), 300)
        (d + torch.mean(f ** 2)).backward()
    finally:
        for p in enc.parameters():
            p.requires_grad_(True)
    np.testing.assert_allclose(float(loss), float(g_loss), rtol=1e-5)
    # as test_torch_slm.py holds the feature loss's: 1e-5 of the largest
    close(g_y, yt.grad, rtol=0.0, atol=1e-5)
    np.testing.assert_allclose(float(d), float(d_loss), rtol=1e-5)
    close(fwd, f)
    assert_grads_close(g_wd, port_grads(wd))
    assert all(p.grad is None for p in enc.parameters())
    nets["wd"].zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# the SLM update's clip and scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thresh", [5.0, 1e3])
def test_clip_and_scale_module_grads_as_jax(thresh):
    """``clip_by_global_norm_if_above`` over two nets (one parameter
    without a gradient) rescales to the threshold only above it, then
    ``scale_module_grads`` scales one net: against the JAX functions."""
    _, nets, *_ = stage2_tiny()
    a, b = copy.deepcopy(nets["bert_encoder"]), copy.deepcopy(nets["predictor"].duration_proj)
    rng = np.random.default_rng(8)
    grads = {}
    for name, m in (("a", a), ("b", b)):
        for k, p in m.named_parameters():
            if (name, k) == ("a", "bias"):
                continue                                  # outside the graph: no .grad
            g = rnd(rng, *p.shape)
            grads[f"{name}.{k}"] = g
            p.grad = t_(g)
    tree = {"a": {"weight": grads["a.weight"], "bias": np.zeros_like(a.bias.detach().numpy())},
            "b": {k[2:]: v for k, v in grads.items() if k.startswith("b.")}}
    j_clipped, j_norm = j_opt.clip_by_global_norm_if_above(tree, thresh)
    j_scaled = j_opt.scale_module_grads(j_clipped, {"b": 0.01})
    np.testing.assert_allclose(float(global_grad_norm([a, b])), float(j_norm), rtol=1e-6)
    norm = clip_by_global_norm_if_above([a, b], thresh)
    np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-6)
    assert (float(norm) > thresh) == (thresh == 5.0)
    scale_module_grads([b], 0.01)
    close(j_scaled["a"]["weight"], a.weight.grad, rtol=1e-6)
    assert a.bias.grad is None
    for k, p in b.named_parameters():
        close(flatten(j_scaled["b"])[k], p.grad, rtol=1e-6)
