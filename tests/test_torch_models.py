"""The port's model modules against the JAX package's, on the tiny config
(styletts2_tpu/testing.py), one parameter tree loaded into both.

Tolerances are 1e-5 in f32, looser only where the port's exact torch.sin and
torch.stft meet the JAX package's sine polynomials and FFT (each noted).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.audio.stft import istft_from_mag_phase as j_istft
from styletts2_tpu.audio.stft import stft_mag_phase as j_stft_mag_phase
from styletts2_tpu.infer import InferenceEngine as JaxEngine
from styletts2_tpu.models import adain_blocks as j_adain_blocks
from styletts2_tpu.models import common as j_cm
from styletts2_tpu.models import plbert as j_plbert
from styletts2_tpu.models import predictor as j_predictor
from styletts2_tpu.models import text_encoder as j_text_encoder
from styletts2_tpu.models.decoder import istftnet as j_istftnet
from styletts2_tpu.models.decoder import source as j_source
from styletts2_tpu.models.diffusion import denoiser as j_denoiser
from styletts2_tpu.models.diffusion import sampler as j_sampler
from styletts2_tpu.nn.linear import linear as j_linear
from styletts2_tpu.nn.lstm import bilstm as j_bilstm
from styletts2_tpu.testing import tiny_model_params
from styletts2_tpu.utils import materialize_params
from styletts2_tpu_torch.audio import stft as t_stft
from styletts2_tpu_torch.config import (
    DecoderConfig, DiffusionConfig, DiffusionTransformerConfig, ModelParams)
from styletts2_tpu_torch.models import adain_blocks as t_adain_blocks
from styletts2_tpu_torch.models import plbert as t_plbert
from styletts2_tpu_torch.models import predictor as t_predictor
from styletts2_tpu_torch.models import text_encoder as t_text_encoder
from styletts2_tpu_torch.models.decoder import istftnet as t_istftnet
from styletts2_tpu_torch.models.decoder import source as t_source
from styletts2_tpu_torch.models.diffusion import denoiser as t_denoiser
from styletts2_tpu_torch.models.diffusion import sampler as t_sampler
from styletts2_tpu_torch.models.zoo import build_nets, load_jax_params

torch.set_num_threads(1)

PLBERT = dict(vocab_size=179, embedding_size=8, hidden_size=24, num_attention_heads=2,
              intermediate_size=32, max_position_embeddings=64, num_hidden_layers=1)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(theirs, ours, atol=1e-5, rtol=1e-5):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol)


@functools.lru_cache(maxsize=None)
def tiny():
    """(JAX params as numpy, the port's nets with them loaded, configs)."""
    jmp = tiny_model_params()
    jpl = j_plbert.PLBertConfig(**PLBERT)
    tr = jmp.diffusion.transformer

    def init(key):
        ks = jax.random.split(key, 6)
        return {
            "bert": j_plbert.init_plbert(ks[0], jpl),
            "bert_encoder": j_cm.init_linear(ks[1], jpl.hidden_size, jmp.hidden_dim),
            "predictor": j_predictor.init_prosody_predictor(
                ks[2], jmp.style_dim, jmp.hidden_dim, jmp.n_layer, jmp.max_dur),
            "decoder": j_istftnet.init_decoder(ks[3], jmp.decoder, jmp.hidden_dim,
                                               jmp.style_dim, width=64, asr_res_ch=8),
            "text_encoder": j_text_encoder.init_text_encoder(
                ks[4], jmp.n_token, jmp.hidden_dim, kernel_size=5, depth=jmp.n_layer),
            "diffusion": {"transformer": j_denoiser.init_denoiser(
                ks[5], channels=jmp.style_dim * 2, context_embedding_features=jpl.hidden_size,
                num_layers=tr.num_layers, num_heads=tr.num_heads,
                head_features=tr.head_features, multiplier=tr.multiplier,
                embedding_max_length=jpl.max_position_embeddings)},
        }

    # shapes from the JAX initialisers without compiling them, values from
    # the JAX package's seeded numpy fill; Snake alphas at their init value 1
    zoo = materialize_params(jax.eval_shape(init, jax.random.PRNGKey(0)), seed=0)
    zoo = jax.tree_util.tree_map_with_path(
        lambda path, a: np.ones_like(a) if "alpha" in jax.tree_util.keystr(path)
        else np.asarray(a), zoo)
    mp = ModelParams(dim_in=4, hidden_dim=32, max_conv_dim=32, n_layer=1, n_token=179,
                     max_dur=10, style_dim=16,
                     decoder=DecoderConfig(upsample_initial_channel=32),
                     diffusion=DiffusionConfig(transformer=DiffusionTransformerConfig(
                         num_layers=1, num_heads=2, head_features=8, multiplier=1)))
    assert mp.decoder == DecoderConfig(**jmp.decoder.__dict__)
    pl = t_plbert.PLBertConfig(**PLBERT)
    nets = load_jax_params(build_nets(mp, pl, decoder_width=64, decoder_asr_res_ch=8), zoo)
    return zoo, nets, jmp, jpl, mp, pl


def test_text_encoder():
    zoo, nets, *_ = tiny()
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 179, (2, 13)).astype(np.int32)
    lengths = np.array([13, 7], np.int32)
    theirs = j_text_encoder.text_encoder_apply(zoo["text_encoder"], jnp.asarray(tokens),
                                               jnp.asarray(lengths))
    ours = t_text_encoder.text_encoder_apply(nets["text_encoder"], t_(tokens).long(),
                                             t_(lengths))
    close(theirs, ours)


def test_plbert_and_position_resize():
    zoo, nets, _, jpl, _, pl = tiny()
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 179, (2, 11)).astype(np.int32)
    mask = (np.arange(11)[None, :] < np.array([11, 6])[:, None]).astype(np.int32)
    theirs = j_plbert.plbert_apply(zoo["bert"], jnp.asarray(tokens), jnp.asarray(mask), jpl)
    ours = t_plbert.plbert_apply(nets["bert"], t_(tokens).long(), t_(mask))
    close(np.asarray(theirs)[mask > 0], ours.detach().numpy()[mask > 0], atol=1e-5)

    grown = j_plbert.resize_position_embeddings(zoo["bert"], 100)
    close(grown["embeddings"]["position_embeddings"]["weight"],
          t_plbert.grown_position_table(nets["bert"], 100), atol=0)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_denoiser_cfg(scale):
    """Pad keys masked out of attention and the mean pool; scale 2 runs the
    conditional and fixed-embedding branches as one doubled batch."""
    zoo, nets, jmp, *_ = tiny()
    rng = np.random.default_rng(2)
    c = jmp.style_dim * 2
    x, time, emb = rnd(rng, 2, 1, c), rnd(rng, 2), rnd(rng, 2, 9, PLBERT["hidden_size"])
    mask = np.arange(9)[None, :] < np.array([9, 5])[:, None]
    theirs = j_denoiser.denoiser_cfg_apply(
        zoo["diffusion"]["transformer"], jnp.asarray(x), jnp.asarray(time), jnp.asarray(emb),
        embedding_scale=scale, num_heads=jmp.diffusion.transformer.num_heads,
        mask=jnp.asarray(mask))
    ours = t_denoiser.denoiser_cfg_apply(nets["diffusion"]["transformer"], t_(x), t_(time),
                                         t_(emb), embedding_scale=scale, mask=t_(mask))
    close(theirs, ours)


def test_adpm2_sample_with_jax_step_noise():
    """The sampler fed the per-step noise JAX draws with fold_in(key, i)."""
    zoo, nets, jmp, *_ = tiny()
    rng = np.random.default_rng(3)
    c, steps = jmp.style_dim * 2, 5
    emb = rnd(rng, 2, 9, PLBERT["hidden_size"])
    mask = np.arange(9)[None, :] < np.array([9, 5])[:, None]
    noise = rnd(rng, 2, 1, c)
    key = jax.random.PRNGKey(5)
    step_noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), (2, 1, c)))
                           for i in range(steps - 1)])

    def jnet(x, c_noise):
        return j_denoiser.denoiser_cfg_apply(
            zoo["diffusion"]["transformer"], x, c_noise, jnp.asarray(emb),
            num_heads=jmp.diffusion.transformer.num_heads, mask=jnp.asarray(mask))

    theirs = j_sampler.adpm2_sample(key, jnp.asarray(noise), j_sampler.k_denoise_fn(jnet, 0.2),
                                    j_sampler.karras_schedule(steps), steps, clamp=False)
    tnet = functools.partial(t_denoiser.denoiser_cfg_apply, nets["diffusion"]["transformer"],
                             embedding=t_(emb), mask=t_(mask))
    with torch.no_grad():
        ours = t_sampler.adpm2_sample(t_(noise), t_sampler.k_denoise_fn(
            lambda x, cn: tnet(x, cn), 0.2), t_sampler.karras_schedule(steps), steps,
            t_(step_noise), clamp=False)
    close(j_sampler.karras_schedule(steps), t_sampler.karras_schedule(steps))
    close(theirs, ours, atol=2e-5)


def test_predictor_durations_and_f0n():
    zoo, nets, jmp, *_ = tiny()
    rng = np.random.default_rng(4)
    b, t, hid, sty = 2, 10, jmp.hidden_dim, jmp.style_dim
    d_en, s = rnd(rng, b, hid, t), rnd(rng, b, sty, scale=0.3)
    lengths = np.array([10, 6], np.int32)
    jp, tp = zoo["predictor"], nets["predictor"]
    j_d = j_predictor.duration_encoder_apply(jp["text_encoder"], jnp.asarray(d_en),
                                             jnp.asarray(s), jnp.asarray(lengths), jmp.n_layer)
    t_d = t_predictor.duration_encoder_apply(tp.text_encoder, t_(d_en), t_(s), t_(lengths))
    close(j_d, t_d)
    # the JAX engine's duration head (styletts2_tpu/infer.py:131-142)
    x = j_bilstm(jp["lstm"], j_d, jnp.asarray(lengths))
    proj = jp["duration_proj"]["linear_layer"]
    dur = jax.nn.sigmoid(j_linear(x, proj["weight"], proj["bias"])).sum(-1)
    mask = np.arange(t)[None, :] < lengths[:, None]
    j_pred = np.where(mask, np.maximum(np.round(np.asarray(dur)), 1.0), 0.0)
    j_pred = j_pred + 5 * (np.arange(t)[None, :] == (lengths - 1)[:, None])
    t_pred = t_predictor.predict_durations(tp, t_d, t_(lengths), last_token_pad=5)
    np.testing.assert_array_equal(t_pred.numpy(), j_pred.astype(np.int32))

    t_mel = 24
    en = rnd(rng, b, hid + sty, t_mel)
    frames = np.array([24, 17], np.int32)
    j_f0, j_n = j_predictor.prosody_f0n_apply(jp, jnp.asarray(en), jnp.asarray(s),
                                              lengths=jnp.asarray(frames))
    t_f0, t_n = t_predictor.prosody_f0n_apply(tp, t_(en), t_(s), lengths=t_(frames))
    close(j_f0, t_f0)
    close(j_n, t_n)


def test_adain_resblk1d_upsample_masked():
    zoo, nets, *_ = tiny()
    blk_j = zoo["predictor"]["F0"]["1"]
    blk_t = nets["predictor"].F0["1"]
    rng = np.random.default_rng(5)
    x, s = rnd(rng, 2, 32, 15), rnd(rng, 2, 16, scale=0.3)
    lengths = np.array([15, 9], np.int32)
    theirs = j_adain_blocks.adain_resblk1d_apply(blk_j, jnp.asarray(x), jnp.asarray(s),
                                                 upsample=True, lengths=jnp.asarray(lengths))
    ours = t_adain_blocks.adain_resblk1d_apply(blk_t, t_(x), t_(s), lengths=t_(lengths))
    close(theirs, ours)


@pytest.mark.parametrize("dither", [False, True])
def test_source_module_mel(dither):
    """JAX's sine polynomial (sin2pi) vs torch.sin on turns reduced first:
    ~|turns| * eps at up to ~1e3 turns, so 1e-4."""
    zoo, nets, *_ = tiny()
    rng = np.random.default_rng(6)
    b, t_mel, scale = 2, 30, 300
    f0 = np.where(rng.random((b, t_mel)) < 0.2, 0.0, 80 + 150 * rng.random((b, t_mel)))
    f0 = f0.astype(np.float32)
    key = jax.random.PRNGKey(9) if dither else None
    theirs, _, _ = j_source.source_module_apply_mel(
        zoo["decoder"]["generator"]["m_source"], key, jnp.asarray(f0), scale,
        deterministic=not dither)
    noise = None
    if dither:
        noise = t_(np.swapaxes(np.asarray(jax.random.normal(
            jax.random.fold_in(key, 1), (b, t_mel * scale, 9))), 1, 2))
    ours = t_source.source_module_apply_mel(nets["decoder"].generator.m_source, t_(f0),
                                            scale, noise=noise)
    close(theirs, ours, atol=1e-4)
    with pytest.raises(ValueError):
        t_source.source_module_apply_mel(nets["decoder"].generator.m_source, t_(f0), 2)


def test_stft_and_istft():
    """torch.stft / torch.istft vs the JAX framed FFT (n_fft 20, hop 5).
    Phases are compared as unit phasors on bins with magnitude > 1e-3: on a
    near-empty bin the angle is FFT rounding."""
    rng = np.random.default_rng(7)
    x = rnd(rng, 2, 3000, scale=0.3)
    j_mag, j_ph = j_stft_mag_phase(jnp.asarray(x), 20, 5, 20)
    t_mag, t_ph = t_stft.stft_mag_phase(t_(x), 20, 5, 20)
    close(j_mag, t_mag, atol=2e-5)
    keep = np.asarray(j_mag) > 1e-3
    j_z, t_z = np.exp(1j * np.asarray(j_ph)), np.exp(1j * t_ph.numpy())
    np.testing.assert_allclose(t_z[keep], j_z[keep], atol=1e-4)
    mag, ph = np.exp(rnd(rng, 2, 11, 50, scale=0.5)), rnd(rng, 2, 11, 50, scale=2.0)
    close(j_istft(jnp.asarray(mag), jnp.asarray(ph), 20, 5, 20),
          t_stft.istft_from_mag_phase(t_(mag), t_(ph), 20, 5, 20), atol=2e-5)
    # the round trip is exact up to f32 rounding
    close(x[:, : t_mag.shape[-1] * 5 - 5],
          t_stft.istft_from_mag_phase(t_mag, t_ph, 20, 5, 20)[:, : x.shape[1]], atol=2e-5)


def parity_envelope(theirs, ours):
    """PARITY.md's waveform envelope: the first 700 samples (the STFT frame-0
    branch cut) < 0.35; the body at 8e-3 with at most 10 samples over 5e-3
    and a mean under 2e-3."""
    err = np.abs(ours - theirs)
    head, body = err[..., :700], err[..., 700:]
    assert head.max() < 0.35, head.max()
    assert body.max() < 8e-3 and (body > 5e-3).sum() <= 10 and body.mean() < 2e-3, (
        body.max(), (body > 5e-3).sum(), body.mean())


def test_decoder_apply_unfused():
    """The plain decoder vs JAX (the fused one is held to 2e-4 past the head
    in test_torch_mrf.py).  The source carries JAX's dither and F0 is
    unvoiced, which keeps the STFT phases of the source well conditioned;
    with these seeded random weights the decoder amplifies the remaining
    ~1e-6 differences to ~1e-3, so the waveform is held to PARITY.md's
    envelope."""
    zoo, nets, jmp, *_ = tiny()
    rng = np.random.default_rng(8)
    b, t_en = 2, 16
    asr, n = rnd(rng, b, jmp.hidden_dim, t_en), rnd(rng, b, 2 * t_en)
    f0 = np.abs(rnd(rng, b, 2 * t_en)) * 5
    s = rnd(rng, b, jmp.style_dim, scale=0.3)
    lengths = np.array([16, 11], np.int32)
    key = jax.random.PRNGKey(195)
    dither = np.swapaxes(np.asarray(jax.random.normal(
        jax.random.fold_in(key, 1), (b, 2 * t_en * 300, 9))), 1, 2)
    theirs = np.asarray(j_istftnet.decoder_apply(
        zoo["decoder"], jmp.decoder, jnp.asarray(asr), jnp.asarray(f0), jnp.asarray(n),
        jnp.asarray(s), key=key, lengths=jnp.asarray(lengths)))
    with torch.no_grad():
        ours = t_istftnet.decoder_apply(nets["decoder"], t_(asr), t_(f0), t_(n), t_(s),
                                        lengths=t_(lengths), source_noise=t_(dither)).numpy()
    parity_envelope(theirs, ours)


def test_engine_tokens_match():
    zoo, nets, jmp, jpl, mp, pl = tiny()
    from styletts2_tpu_torch.infer import InferenceEngine

    ours = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    theirs = JaxEngine({"bert": zoo["bert"]}, jmp, jpl)
    for text in ("ðə kwɪk bɹaʊn fɑks", "hɛloʊ wɜːld."):
        np.testing.assert_array_equal(ours.tokens_from_phonemes(text),
                                      theirs.tokens_from_phonemes(text))
