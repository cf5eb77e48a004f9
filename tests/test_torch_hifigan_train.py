"""The HiFi-GAN decoder's training form and the multispeaker HiFi-GAN
stage-1 step, against the JAX package on the CPU at the tiny size.

- The decoder: ``hifigan.decoder_apply`` with the smoothing indices and the
  source dither that JAX's ``decoder_apply(train=True, key)`` draws from its
  key (``random_smooth`` at ``fold_in(key, 11)``/``(key, 12)``, the SineGen
  dither at ``fold_in(key, 1)``), unvoiced F0 (the sine bank's polynomial
  stays out, PARITY.md): the waveform at 1e-5, and the gradients of a fixed
  cotangent on it to every decoder leaf at 1e-3 of each leaf's largest
  (+ 1e-5 of the whole tree's largest, for leaves whose true gradient is
  0), ``test_torch_stage1.py``'s bound for the decoder's backward (measured
  up to 1.05e-4 of a leaf's largest, in a noise conv's bias, a sum over
  12000 frames), and to the inputs at 1e-4 of each input's largest.  Both
  packages stop the gradient at the sine bank only, so the source's merge
  layer ``m_source.l_linear`` is held with the other leaves.
- The stage-1 step of the multispeaker HiFi-GAN model: the port's
  ``stage1_loss`` against a JAX composition of ``Stage1Trainer``'s lines
  (``styletts2_tpu/train/stage1.py:133-176``) with the style taken from a
  second clip (``mel_len_st``) and the HiFi-GAN decoder in its training
  form, before TMA (the STFT loss into the text encoder, style encoder and
  decoder) and with TMA (``lambda_mel`` x STFT + the aligner's ``mono`` and
  ``s2s`` losses into those and the aligner and pitch extractor), under
  both alignment draws.  The JAX side runs as three jitted pieces chained
  by the chain rule: the lines before the decoder, the decoder (the same
  compiled function as the decoder's test, on the same shapes) and the
  STFT loss; each piece's vector-Jacobian product takes the next one's
  input gradient as its cotangent.  Split at the waveform: the GAN and
  Whisper terms from ``y_rec`` on are ``test_torch_tma.py``'s.  The
  alignment runs in its eval form on both sides (no dropout draws), as in
  ``test_torch_stage1.py``.  The HiFi-GAN injects its harmonic source raw
  (no STFT, so none of the iSTFTNet's phase branch cut, ROADMAP.md section
  C).  Held: the loss at 1e-5 relative, the waveform at 1e-5 of its
  largest, and each trained leaf's gradient at max|diff| <= 1e-3
  max|g_leaf| + 1e-5 max|g_net|, the pitch extractor's with 3e-4 of its
  net's largest in place of 1e-5: its frequency max-pools hold windows
  whose two largest bins lie within rounding of each other, so the
  packages' ~1e-6 forward differences move an argmax
  (``test_torch_tma.py`` measured 4.8e-5 of the net's largest on its own
  cotangent; the decoder's, here, 1.7e-4 in the first conv).
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
from styletts2_tpu.losses.stft_loss import multi_resolution_stft_loss
from styletts2_tpu.models.decoder import hifigan as j_hifigan
from styletts2_tpu.models.jdc import jdc_apply
from styletts2_tpu.models.style_encoder import style_encoder_apply
from styletts2_tpu.models.text_encoder import text_encoder_apply
from styletts2_tpu.testing import tiny_model_params
from styletts2_tpu.train.stage1 import compute_alignment as j_compute_alignment
from styletts2_tpu_torch.config import Config, ModelParams, _build
from styletts2_tpu_torch.models.asr import ASRNoise
from styletts2_tpu_torch.models.decoder import decoder_apply, hifigan
from styletts2_tpu_torch.models.zoo import flatten
from styletts2_tpu_torch.train.stage1 import (TMA_TRAINED, TRAINED, Stage1Noise, mono_loss,
                                              s2s_loss, stage1_loss)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_aux import J_ASR, J_JDC  # noqa: E402
from test_torch_hifigan import decoder_inputs, dither, tiny_decoder  # noqa: E402
from test_torch_multispeaker import ASR_RES, WIDTH, tiny_ms  # noqa: E402
from test_torch_stage1 import (B, HOP, MEL_LEN, jax_draws, make_batch, sharp_tiny,  # noqa
                               torch_batch)
from test_torch_stage2_parts import assert_grads_close  # noqa: E402

torch.set_num_threads(1)

LP = Config().loss_params
BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def decoder_grads_close(theirs, m, rtol, net_tol):
    """``assert_grads_close`` over every decoder leaf, the source merge's
    ``m_source.l_linear`` included."""
    assert all(p.grad is not None for p in m.generator.m_source.parameters())
    assert_grads_close(flatten(theirs), {k: p.grad for k, p in m.named_parameters()},
                       rtol=rtol, net_tol=net_tol)


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def jax_training_decoder():
    """The JAX decoder's training-form waveform and the gradients of
    sum(y * cot) to its parameters and to asr, f0, n and s, for a key."""
    cfg = tiny_model_params(multispeaker=True, decoder_type="hifigan").decoder

    def fn(p, ins, cot, key):
        def out(p, ins):
            return j_hifigan.decoder_apply(p, cfg, *ins, key=key, train=True)
        y, vjp = jax.vjp(out, p, ins)
        return y, vjp(cot)

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def ms_stage1():
    """(JAX tree, the port's nets, JAX ModelParams, port ModelParams): the
    tiny stage-1 nets with the sharpened aligner of ``test_torch_stage1``
    and the tiny multispeaker model's HiFi-GAN decoder."""
    zoo, nets, _, _ = sharp_tiny()
    ms_zoo, ms_nets, jmp, *_ = tiny_ms()
    zoo = {**zoo, "decoder": ms_zoo["decoder"]}
    nets = copy.deepcopy(nets)
    nets["decoder"] = copy.deepcopy(ms_nets["decoder"])
    mp = _build(ModelParams, dataclasses.asdict(jmp))
    assert mp.multispeaker and isinstance(nets["decoder"], hifigan.Decoder)
    assert (WIDTH, ASR_RES) == (64, 8)
    return zoo, nets, jmp, mp


@pytest.mark.parametrize("seed", [1, 24])
def test_training_decoder_and_gradients_match_jax(seed):
    """Key 1 draws the smoothing widths (7, 15) and key 24 (3, 3).  The
    decoder and its inputs (en, F0, N, s) are the stage-1 step's below, from
    the JAX lines before the decoder with the monotonic alignment, so both
    tests share one compiled JAX decoder."""
    zoo, nets, _, _ = ms_stage1()
    params, m = zoo["decoder"], copy.deepcopy(nets["decoder"]).train()
    ins, _, _ = jax_front_fn()(True, np.array([0.25, 0.6], np.float32),
                               np.array([0.5, 0.3], np.float32))
    asr, f0, n, s = (np.asarray(v) for v in ins)
    key = jax.random.PRNGKey(seed)
    f0_idx, n_idx, _ = jax_draws(key, 1)
    assert (f0_idx, n_idx) == {1: (2, 3), 24: (1, 1)}[seed]
    t_audio = 2 * MEL_LEN * HOP
    cot = np.random.default_rng(seed).standard_normal((B, 1, t_audio)).astype(np.float32)
    ins = tuple(jnp.asarray(v) for v in (asr, f0, n, s))
    y_j, (g_params, g_ins) = jax_training_decoder()(params, ins, jnp.asarray(cot), key)

    leaves = [t_(v).requires_grad_() for v in (asr, f0, n, s)]
    y = decoder_apply(m, *leaves, source_noise=t_(dither(key, B, 2 * MEL_LEN)),
                      smooth=(torch.tensor(f0_idx), torch.tensor(n_idx)))
    assert y.shape == (B, 1, t_audio)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    (y * torch.from_numpy(cot)).sum().backward()
    decoder_grads_close(g_params, m, rtol=1e-3, net_tol=1e-5)
    for name, mine, theirs in zip(("asr", "f0", "n", "s"), leaves, g_ins):
        theirs = np.asarray(theirs)
        err = float(np.abs(mine.grad.numpy() - theirs).max())
        assert err <= 1e-4 * float(np.abs(theirs).max()), (name, err)


def test_training_decoder_keeps_the_fused_path_out():
    """The fused decoder has no backward: under ``smooth`` it raises."""
    _, m, _ = tiny_decoder()
    asr, f0, n, s, _ = (t_(v) for v in decoder_inputs(3))
    with pytest.raises(ValueError, match="fused"):
        hifigan.decoder_apply(m, asr, f0, n, s, fused=True,
                              smooth=(torch.tensor(0), torch.tensor(0)))


# ---------------------------------------------------------------------------
# the stage-1 step of the multispeaker HiFi-GAN model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_front_fn():
    """One jitted function for the stage-1 lines before the decoder: the
    decoder's inputs (en, F0, N, s), the wave's clip, the mono and s2s
    losses, and the gradients to the nets of <inputs, cot> + w[0] mono +
    w[1] s2s."""
    zoo, _, _, _ = ms_stage1()
    batch = make_batch()
    waves = jnp.asarray(batch["waves"])
    mels = log_mel_spectrogram(waves, DATASET_MEL)
    mels = mels[..., : (mels.shape[-1] // 2) * 2]
    mel_lengths = jnp.asarray(batch["mel_input_length"], jnp.int32)
    texts = jnp.asarray(batch["texts"], jnp.int32)
    text_lengths = jnp.asarray(batch["input_lengths"], jnp.int32)
    half_len = mel_lengths // 2

    def clip(x, starts, length):
        return jax.vmap(lambda xi, st: jax.lax.dynamic_slice_in_dim(xi, st, length,
                                                                    axis=xi.ndim - 1))(x, starts)

    def starts_of(u):
        return (u * jnp.maximum(half_len - MEL_LEN, 1).astype(jnp.float32)).astype(jnp.int32)

    def front(gen, use_mono, u, u2):
        # styletts2_tpu/train/stage1.py:133-176 up to the decoder, the
        # alignment in its eval form
        _, s2s_pred, s2s_attn, mono = j_compute_alignment(
            gen, mels, mel_lengths, texts, text_lengths, J_ASR, train=False, rng=None)
        t_en = text_encoder_apply(gen["text_encoder"], texts, text_lengths)
        asr_feats = t_en @ jnp.where(use_mono, mono, s2s_attn)
        starts = starts_of(u)
        en = clip(asr_feats, starts, MEL_LEN)
        gt = jax.lax.stop_gradient(clip(mels, starts * 2, MEL_LEN * 2))
        wav = clip(waves, starts * 2 * HOP, MEL_LEN * 2 * HOP)
        st = jax.lax.stop_gradient(clip(mels, starts_of(u2) * 2, MEL_LEN * 2))
        f0_real, _, _ = jdc_apply(gen["pitch_extractor"], gt[:, None], J_JDC)
        s = style_encoder_apply(gen["style_encoder"], st[:, None])
        logits = s2s_pred[:, :-1, :]
        tmask = (jnp.arange(logits.shape[1])[None, :] < text_lengths[:, None]).astype(
            jnp.float32)
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, axis=-1), texts[..., None],
                                   axis=-1)[..., 0]
        loss_s2s = jnp.mean((nll * tmask).sum(1) / jnp.maximum(tmask.sum(1), 1))
        loss_mono = jnp.mean(jnp.abs(s2s_attn - jax.lax.stop_gradient(mono))) * 10.0
        return (en, f0_real, log_norm(gt), s), (loss_mono, loss_s2s), wav

    def fn(gen, use_mono, u, u2, cot, w):
        def f(g):
            ins, (mono, s2s), wav = front(g, use_mono, u, u2)
            return (ins, w[0] * mono + w[1] * s2s), (wav, mono, s2s)
        (ins, _), vjp, aux = jax.vjp(f, gen, has_aux=True)
        (grads,) = vjp((cot, jnp.float32(1.0)))
        return ins, aux, grads

    gen = {k: zoo[k] for k in TMA_TRAINED if k != "decoder"}
    jitted = jax.jit(fn)
    args = lambda use_mono, u, u2: (gen, jnp.bool_(use_mono), jnp.asarray(u),  # noqa: E731
                                    jnp.asarray(u2))
    shapes = jax.eval_shape(lambda *a: front(*a)[0], *args(False, np.zeros(B, np.float32),
                                                           np.zeros(B, np.float32)))
    zeros = tuple(jnp.zeros(a.shape, a.dtype) for a in shapes)
    return lambda use_mono, u, u2, cot=zeros, w=(0.0, 0.0): jitted(
        *args(use_mono, u, u2), cot, jnp.asarray(w, jnp.float32))


@functools.lru_cache(maxsize=None)
def jax_stft_grad():
    return jax.jit(jax.value_and_grad(
        lambda y, wav: multi_resolution_stft_loss(y[:, 0, :], wav)))


def jax_stage1(use_mono, u, u2, key, tma):
    """The JAX composition's loss (the STFT loss before TMA, ``lambda_mel``
    x STFT + mono + s2s with it), its gradients to the five nets TMA trains,
    the STFT loss, the waveform and F0, chained at the decoder's inputs and
    at its waveform."""
    zoo, _, _, _ = ms_stage1()
    front, decoder = jax_front_fn(), jax_training_decoder()
    ins, (wav, mono, s2s), _ = front(use_mono, u, u2)
    y, _ = decoder(zoo["decoder"], ins, jnp.zeros((B, 1, 2 * MEL_LEN * HOP)), key)
    mel, dy = jax_stft_grad()(y, wav)
    lam = LP.lambda_mel if tma else 1.0
    w = (LP.lambda_mono, LP.lambda_s2s) if tma else (0.0, 0.0)
    _, (g_dec, g_ins) = decoder(zoo["decoder"], ins, lam * dy, key)
    _, _, grads = front(use_mono, u, u2, g_ins, w)
    loss = lam * mel + w[0] * mono + w[1] * s2s
    return mel, loss, {**grads, "decoder": g_dec}, y, ins[1]


@pytest.mark.parametrize("tma", [False, True])
@pytest.mark.parametrize("use_mono", [False, True])
def test_multispeaker_hifigan_stage1_step_matches_jax(use_mono, tma):
    _, nets, _, mp = ms_stage1()
    nets = copy.deepcopy(nets)
    u = np.array([0.73, 0.41], np.float32)
    u2 = np.array([0.12, 0.88], np.float32)
    key = jax.random.PRNGKey({(False, False): 8, (True, False): 4,
                              (False, True): 17, (True, True): 21}[(use_mono, tma)])
    mel_j, loss_j, grads, y_j, f0 = jax_stage1(use_mono, u, u2, key, tma)
    # unvoiced F0 keeps the sine bank (torch.sin vs the JAX polynomial) out
    assert float(jnp.max(f0)) < 10.0
    f0_idx, n_idx, _ = jax_draws(key, 1)
    noise = Stage1Noise(asr=ASRNoise(), text_keep=None, use_mono=torch.tensor(use_mono),
                        clip_u=torch.from_numpy(u), style_clip_u=torch.from_numpy(u2),
                        f0_smooth=torch.tensor(f0_idx), n_smooth=torch.tensor(n_idx),
                        source_noise=t_(dither(key, B, MEL_LEN * 2)))
    loss_mel, aux = stage1_loss(nets, mp, torch_batch(make_batch()), noise, MEL_LEN, MEL_LEN,
                                tma=tma)
    y = aux["y_rec"].detach().numpy()
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(y_j)).max()))
    np.testing.assert_allclose(float(loss_mel), float(mel_j), rtol=1e-5)
    if tma:
        loss = (LP.lambda_mel * loss_mel + LP.lambda_mono * mono_loss(
            aux["s2s_attn"], aux["s2s_attn_mono"])
            + LP.lambda_s2s * s2s_loss(aux["s2s_pred"], aux["texts"], aux["text_lengths"]))
    else:
        loss = loss_mel
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    loss.backward()
    for name in TMA_TRAINED if tma else TRAINED:
        # the JAX tree holds the pitch extractor's batch-norm statistics as
        # leaves; the port keeps them as buffers (ROADMAP.md section C)
        if name == "decoder":
            decoder_grads_close(grads[name], nets[name], rtol=1e-3, net_tol=1e-5)
            continue
        theirs = {k: v for k, v in flatten(grads[name]).items() if not k.endswith(BN_STATS)}
        assert_grads_close(theirs, {k: p.grad for k, p in nets[name].named_parameters()},
                           rtol=1e-3, net_tol=3e-4 if name == "pitch_extractor" else 1e-5)
    for name in set(nets) - set(TMA_TRAINED if tma else TRAINED):
        assert all(p.grad is None for p in nets[name].parameters()), name
