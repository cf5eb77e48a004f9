"""The port's pre-TMA stage-1 training step against a JAX composition, the
per-net AdamW against optax, and ``run_stage1`` on the CPU.

The JAX side is built here from the JAX package's public functions
(``compute_alignment`` in eval form, ``text_encoder_apply``, ``jdc_apply``,
``style_encoder_apply``, ``decoder_apply(train=True)`` and
``multi_resolution_stft_loss``) and differentiated with one jitted
``jax.value_and_grad`` over the text encoder, style encoder and decoder.
The port's step is fed the same clip starts and both values of
``use_mono``, no dropout, and the smoothing indices and source dither JAX
draws from the decoder's key (``istftnet.py:255,283-285``,
``source.py:168-169``): the dither keeps the source STFT's atan2 phases
well conditioned (ROADMAP.md §C).

The branch cut.  STFT frame 0 of the harmonic source is even-symmetric, so
every bin's imaginary part is rounding noise; where the real part is
negative, atan2 gives +pi on one side and -pi on the other, and the decoder
feeds that 2*pi jump to a convolution (PARITY.md's 0.35 waveform head).  The
comparison canonicalises that branch cut on both sides alike, for this test
only: a phase within 1e-4 of -pi becomes its +pi twin.  The waveforms then
agree at ~5e-6, and:
- the loss is held at 1e-5 relative;
- the backward of the whole step is held through a fixed cotangent on the
  waveform: each leaf's max|diff| <= 1e-3 * max|g_leaf| + 1e-5 * max|g_net|
  (the second term for leaves whose true gradient is 0, a bias or gain right
  before an instance norm, where both sides hold rounding noise);
- the loss's own gradients, where the STFT loss's L1 turns the ~5e-6
  waveform differences into sign flips bin by bin (measured up to 1.3% of
  the text encoder's largest gradient), are held per net at
  max|diff| <= 3e-2 * max|g_net|.
"""

import copy
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from styletts2_tpu.audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from styletts2_tpu.losses.stft_loss import multi_resolution_stft_loss
from styletts2_tpu.models.decoder import istftnet as j_istftnet
from styletts2_tpu.models.jdc import jdc_apply
from styletts2_tpu.models.style_encoder import style_encoder_apply
from styletts2_tpu.models.text_encoder import text_encoder_apply
from styletts2_tpu.train.stage1 import compute_alignment as j_compute_alignment
from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models.asr import ASRNoise
from styletts2_tpu_torch.models.decoder import istftnet as t_istftnet
from styletts2_tpu_torch.models.zoo import STAGE1_NETS, flatten
from styletts2_tpu_torch.train.loop import make_lr_map, run_stage1
from styletts2_tpu_torch.train.optimizers import MultiOptimizer
from styletts2_tpu_torch.train.stage1 import (TRAINED, Stage1Noise, Stage1Trainer,
                                              stage1_loss)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_aux import J_ASR, J_JDC, stage1_tiny  # noqa: E402

torch.set_num_threads(1)

B, T_TEXT, MEL_LEN = 2, 12, 40
HOP = 300


def make_batch(seed=0):
    """Waves at 0.1 N(0, 1) of 96 and 90 mel frames, 12 and 9 tokens."""
    rng = np.random.default_rng(seed)
    frames = np.array([96, 90])
    waves = (0.1 * rng.standard_normal((B, (frames.max() - 1) * HOP))).astype(np.float32)
    texts = rng.integers(4, 179, (B, T_TEXT)).astype(np.int64)
    return {"waves": waves, "mel_input_length": frames, "texts": texts,
            "input_lengths": np.array([T_TEXT, 9])}


def torch_batch(batch):
    out = {"waves": torch.from_numpy(batch["waves"])}
    for k in ("mel_input_length", "texts", "input_lengths"):
        out[k] = torch.from_numpy(batch[k]).long()
    return out


def jax_step_fn(zoo, jmp):
    """One jitted value_and_grad of the pre-TMA generator loss over the text
    encoder, style encoder and decoder, with use_mono and the clip uniforms
    as arguments."""
    batch = make_batch()
    waves = jnp.asarray(batch["waves"])
    mels = log_mel_spectrogram(waves, DATASET_MEL)
    mels = mels[..., : (mels.shape[-1] // 2) * 2]
    mel_lengths = jnp.asarray(batch["mel_input_length"], jnp.int32)
    texts = jnp.asarray(batch["texts"], jnp.int32)
    text_lengths = jnp.asarray(batch["input_lengths"], jnp.int32)
    _, _, s2s_attn, mono = j_compute_alignment(zoo, mels, mel_lengths, texts, text_lengths,
                                               J_ASR, train=False, rng=None)
    half_len = mel_lengths // 2

    def clip(x, starts, length):
        return jax.vmap(lambda xi, st: jax.lax.dynamic_slice_in_dim(xi, st, length,
                                                                    axis=xi.ndim - 1))(x, starts)

    def forward(gen, use_mono, u, key):
        t_en = text_encoder_apply(gen["text_encoder"], texts, text_lengths)
        attn = jnp.where(use_mono, mono, s2s_attn)
        asr_feats = t_en @ attn
        starts = (u * jnp.maximum(half_len - MEL_LEN, 1).astype(jnp.float32)).astype(jnp.int32)
        en = clip(asr_feats, starts, MEL_LEN)
        gt = clip(mels, starts * 2, MEL_LEN * 2)
        wav = clip(waves, starts * 2 * HOP, MEL_LEN * 2 * HOP)
        real_norm = log_norm(gt)
        f0_real, _, _ = jdc_apply(zoo["pitch_extractor"], gt[:, None], J_JDC)
        s = style_encoder_apply(gen["style_encoder"], gt[:, None])
        y_rec = j_istftnet.decoder_apply(gen["decoder"], jmp.decoder, en, f0_real, real_norm,
                                         s, key=key, train=True)
        return multi_resolution_stft_loss(y_rec[:, 0, :], wav), (y_rec, f0_real)

    def both(gen, use_mono, u, key, cot):
        (loss, (_, f0)), g_loss = jax.value_and_grad(forward, has_aux=True)(
            gen, use_mono, u, key)
        g_cot = jax.grad(lambda g: jnp.sum(forward(g, use_mono, u, key)[1][0] * cot))(gen)
        return loss, f0, g_loss, g_cot

    fn = jax.jit(both)
    gen = {k: zoo[k] for k in TRAINED}
    return lambda use_mono, u, key, cot: fn(gen, jnp.bool_(use_mono), jnp.asarray(u), key,
                                            jnp.asarray(cot))


def jax_draws(key, t_audio):
    """The smoothing indices and the source dither JAX draws from the
    decoder's key."""
    f0_idx = jax.random.randint(jax.random.fold_in(key, 11), (), 0, 3)
    n_idx = jax.random.randint(jax.random.fold_in(key, 12), (), 0, 4)
    dither = np.swapaxes(np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                                      (B, t_audio, 9))), 1, 2)
    return int(f0_idx), int(n_idx), dither


def _canonical_phase(stft_mag_phase, where):
    def wrapped(*args, **kw):
        mag, phase = stft_mag_phase(*args, **kw)
        return mag, where(phase < -math.pi + 1e-4, phase + 2 * math.pi, phase)
    return wrapped


def sharp_tiny():
    """The tiny stage-1 tree with the aligner's attention energies scaled by
    20.  The random aligner's attention is near uniform over the frames, so
    the soft-aligned decoder input is near constant in time (temporal std
    down to 7e-7 against means ~1e-3), and the decoder's instance norms
    subtract its mean at a loss of three digits on both sides; sharpened,
    its std is ~4e-4, as the monotonic path's (~2e-3) is."""
    zoo, nets, jmp, mp, *_ = stage1_tiny()
    zoo = copy.deepcopy(zoo)
    v = zoo["text_aligner"]["asr_s2s"]["attention_layer"]["v"]["linear_layer"]
    v["weight"] = v["weight"] * np.float32(20.0)
    nets = copy.deepcopy(nets)
    nets["text_aligner"].asr_s2s.attention_layer["v"]["linear_layer"].weight.data.mul_(20.0)
    return zoo, nets, jmp, mp


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step with the branch cut canonicalised in the JAX decoder
    (traced at its first call, inside the module's first step test)."""
    j_orig = j_istftnet.stft_mag_phase
    j_istftnet.stft_mag_phase = _canonical_phase(j_orig, jnp.where)
    try:
        zoo, nets, jmp, mp = sharp_tiny()
        yield jax_step_fn(zoo, jmp), nets, mp
    finally:
        j_istftnet.stft_mag_phase = j_orig


@pytest.mark.parametrize("use_mono", [False, True])
def test_step_loss_and_gradients_match_jax(jax_step, use_mono, monkeypatch):
    jax_step, nets, mp = jax_step
    nets = copy.deepcopy(nets)
    monkeypatch.setattr(t_istftnet, "stft_mag_phase",
                        _canonical_phase(t_istftnet.stft_mag_phase, torch.where))
    u = np.array([0.73, 0.41], np.float32)
    key = jax.random.PRNGKey(17 + use_mono)
    cot = np.random.default_rng(5).standard_normal((B, 1, MEL_LEN * 2 * HOP)).astype(
        np.float32)
    j_loss, f0_real, j_g_loss, j_g_cot = jax_step(use_mono, u, key, cot)
    # unvoiced F0 keeps the sine bank (torch.sin vs the JAX polynomial) out
    assert float(jnp.max(f0_real)) < 10.0
    f0_idx, n_idx, dither = jax_draws(key, MEL_LEN * 2 * HOP)
    noise = Stage1Noise(asr=ASRNoise(), text_keep=None, use_mono=torch.tensor(use_mono),
                        clip_u=torch.from_numpy(u), style_clip_u=torch.from_numpy(u),
                        f0_smooth=torch.tensor(f0_idx), n_smooth=torch.tensor(n_idx),
                        source_noise=torch.from_numpy(dither))
    loss, aux = stage1_loss(nets, mp, torch_batch(make_batch()), noise, MEL_LEN, MEL_LEN)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for name, net in nets.items():
        net.zero_grad()
    loss.backward(retain_graph=True)
    g_loss = {n: {k: p.grad.clone() if p.grad is not None else None
                  for k, p in nets[n].named_parameters()} for n in TRAINED}
    for net in nets.values():
        net.zero_grad()
    (aux["y_rec"] * torch.from_numpy(cot)).sum().backward()
    g_cot = {n: {k: p.grad for k, p in nets[n].named_parameters()} for n in TRAINED}
    for name in TRAINED:
        for ours, theirs, leaf_tol, net_tol in ((g_cot, j_g_cot, 1e-3, 1e-5),
                                                (g_loss, j_g_loss, 0.0, 3e-2)):
            flat = {k: np.asarray(g) for k, g in flatten(theirs[name]).items()}
            net_max = max(float(np.abs(g).max()) for g in flat.values())
            for k, g in flat.items():
                if ours[name].get(k) is None:      # the SN vectors (buffers), the source merge
                    assert not g.any(), f"{name}.{k}"
                    continue
                err = float(np.abs(ours[name][k].numpy() - g).max())
                tol = leaf_tol * float(np.abs(g).max()) + net_tol * net_max
                assert err <= tol, (f"{name}.{k}", err, tol)
    for name in ("text_aligner", "pitch_extractor"):
        assert all(p.grad is None for p in nets[name].parameters())


def test_multi_optimizer_matches_optax():
    """Two AdamW updates (betas (0, 0.99), eps 1e-9, weight decay 1e-4, the
    learning rates of ``make_lr_map``) of the nets named, on the same
    gradients as optax's; the nets not named do not move."""
    zoo, nets, *_ = stage1_tiny()
    nets = copy.deepcopy(nets)
    cfg = Config()
    lr_map = make_lr_map(cfg)
    opt = MultiOptimizer(nets, lr_map, default_lr=cfg.optimizer_params.lr)
    active = ("text_encoder", "style_encoder")
    before = {k: copy.deepcopy(v.state_dict()) for k, v in nets.items()}
    params = {n: {k: p.detach().numpy().copy() for k, p in nets[n].named_parameters()}
              for n in active}
    txs = {n: optax.adamw(lr_map.get(n, cfg.optimizer_params.lr), b1=0.0, b2=0.99, eps=1e-9,
                          weight_decay=1e-4) for n in active}
    states = {n: txs[n].init(params[n]) for n in active}
    rng = np.random.default_rng(9)
    for _ in range(2):
        for n in active:
            grads = {}
            for k, p in nets[n].named_parameters():
                grads[k] = (0.01 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
                p.grad = torch.from_numpy(grads[k])
            upd, states[n] = jax.jit(txs[n].update)(grads, states[n], params[n])
            params[n] = optax.apply_updates(params[n], upd)
        opt.step(active)
    for n in active:
        got = dict(nets[n].named_parameters())
        for k, v in params[n].items():
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{n}.{k}")
    for n in STAGE1_NETS:
        if n not in active:
            for k, v in nets[n].state_dict().items():
                assert torch.equal(v, before[n][k]), f"{n}.{k}"


def test_run_stage1_two_steps_on_cpu():
    """Two steps through the driver: finite losses, the trained nets move,
    the frozen ones do not; a batch too short for the style encoder is
    skipped; the TMA phase asks for the nets it adds (``STAGE1_TMA_NETS``)."""
    _, nets, _, mp, asr_cfg, jdc_cfg = stage1_tiny()
    nets = copy.deepcopy(nets)
    before = {k: copy.deepcopy(v.state_dict()) for k, v in nets.items()}
    short = make_batch(2)
    short["mel_input_length"] = np.array([60, 60])
    logs = []

    def loader(epoch):
        yield short
        yield make_batch(0)
        yield make_batch(1)

    cfg = Config(log_interval=1, max_len=80)
    state = run_stage1(cfg, {"model": mp}, nets, loader, max_steps=2,
                       log_cb=lambda it, m: logs.append(m), device="cpu", seed=0)
    assert state.iters == 2 and len(logs) == 2
    assert all(np.isfinite(m["mel_loss"]) for m in logs)
    for name in STAGE1_NETS:
        moved = any(not torch.equal(v, before[name][k])
                    for k, v in nets[name].state_dict().items())
        assert moved == (name in TRAINED), name
    trainer = Stage1Trainer(cfg, {"model": mp}, nets, state.optimizer)
    with pytest.raises(ValueError, match="STAGE1_TMA_NETS"):
        trainer.make_step(True, 40, 40)
