"""The port's HiFi-GAN decoder (models/decoder/hifigan.py) against the JAX
package's, on the tiny multispeaker config (styletts2_tpu/testing.py:
rates 10, 5, 3, 2, 32 initial channels), one parameter tree loaded into
both.

The HiFi-GAN injects the raw harmonic source (no STFT, so no phase on a
branch cut), and the source carries the dither JAX drew from its key.  With
unvoiced F0 (a source of dither alone) the generator and the unfused
decoder are held at 1e-5.  With voiced F0 the source's sines meet JAX's
sine polynomial (~6e-7 apart, PARITY.md), which these seeded random weights
grow to ~7e-4: that case is held to PARITY.md's waveform envelope.  The
fused decoder (the port's plain round on the CPU) is held against the JAX
fused path with its Pallas round in interpret mode.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.models.asr import ASRConfig as JASRConfig
from styletts2_tpu.models.decoder import hifigan as j_hifigan
from styletts2_tpu.models.jdc import JDCConfig as JJDCConfig
from styletts2_tpu.models.plbert import PLBertConfig as JPLBertConfig
from styletts2_tpu.models.zoo import build_zoo
from styletts2_tpu.nn.conv import conv_transpose1d as j_conv_transpose1d
from styletts2_tpu.ops import fused as j_fused
from styletts2_tpu.testing import tiny_model_params
from styletts2_tpu.utils import materialize_params
from styletts2_tpu_torch.config import DecoderConfig, ModelParams, _build
from styletts2_tpu_torch.models.asr import ASRConfig
from styletts2_tpu_torch.models.decoder import hifigan
from styletts2_tpu_torch.models.jdc import JDCConfig
from styletts2_tpu_torch.models.plbert import PLBertConfig
from styletts2_tpu_torch.models.zoo import (build_nets, export_params, flatten,
                                            init_reference_, load_jax_params)
from styletts2_tpu_torch.nn.conv import conv_transpose1d

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_models import parity_envelope  # noqa: E402

torch.set_num_threads(1)

DIM_IN, WIDTH, ASR_RES = 16, 64, 8


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def tiny_decoder():
    """(JAX decoder params, the port's decoder with them loaded, JAX config).
    Shapes from the JAX initialiser without compiling it (a jit of it takes
    about a minute here), values from the JAX package's seeded numpy fill;
    Snake alphas at their init value 1."""
    mp = tiny_model_params(multispeaker=True, decoder_type="hifigan")
    params = materialize_params(jax.eval_shape(lambda key: j_hifigan.init_decoder(
        key, mp.decoder, dim_in=DIM_IN, style_dim=mp.style_dim, width=WIDTH,
        asr_res_ch=ASR_RES), jax.random.PRNGKey(2)), seed=2)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.ones_like(a) if "alpha" in jax.tree_util.keystr(path)
        else np.asarray(a), params)
    cfg = DecoderConfig(**mp.decoder.__dict__)
    m = hifigan.Decoder(cfg, DIM_IN, mp.style_dim, WIDTH, ASR_RES)
    m.load_state_dict({k: t_(v) for k, v in flatten(params).items()}, strict=True)
    return params, m.eval(), mp


def decoder_inputs(seed, b=2, t_en=20, voiced=True):
    mp = tiny_model_params(multispeaker=True, decoder_type="hifigan")
    rng = np.random.default_rng(seed)
    asr, n = rnd(rng, b, DIM_IN, t_en), rnd(rng, b, 2 * t_en)
    f0 = np.abs(rnd(rng, b, 2 * t_en)) * (100 if voiced else 5)
    s = rnd(rng, b, mp.style_dim, scale=0.3)
    lengths = np.asarray([t_en, 14][:b], np.int32)
    return asr, f0, n, s, lengths


def dither(key, b, t_mel):
    """The harmonic source's dither JAX draws from ``key`` (source.py fold_in 1)."""
    return np.swapaxes(np.asarray(jax.random.normal(
        jax.random.fold_in(key, 1), (b, t_mel * 300, 9))), 1, 2)


@functools.lru_cache(maxsize=None)
def jax_decoder(fused: bool):
    """The JAX decoder, jitted once per form (eager, it takes minutes here)."""
    cfg = tiny_model_params(multispeaker=True, decoder_type="hifigan").decoder
    return jax.jit(lambda p, asr, f0, n, s, lengths, key: j_hifigan.decoder_apply(
        p, cfg, asr, f0, n, s, key=key, lengths=lengths, fused=fused))


def test_generator_unfused_matches_jax():
    params, m, mp = tiny_decoder()
    rng = np.random.default_rng(4)
    b, t_mel = 2, 24
    x = rnd(rng, b, mp.decoder.upsample_initial_channel, t_mel)
    s = rnd(rng, b, mp.style_dim, scale=0.3)
    f0 = np.abs(rnd(rng, b, t_mel)) * 5                       # unvoiced
    lengths = np.asarray([24, 17], np.int32)
    key = jax.random.PRNGKey(11)
    theirs = np.asarray(jax.jit(lambda p, xx, ss, ff, k, ln: j_hifigan.generator_apply(
        p, mp.decoder, xx, ss, ff, key=k, deterministic=False, lengths=ln))(
            params["generator"], jnp.asarray(x), jnp.asarray(s), jnp.asarray(f0), key,
            jnp.asarray(lengths)))
    with torch.no_grad():
        ours = hifigan.generator_apply(m.generator, t_(x), t_(s), t_(f0),
                                       lengths=torch.from_numpy(lengths),
                                       source_noise=t_(dither(key, b, t_mel))).numpy()
    assert ours.shape == theirs.shape == (b, 1, t_mel * 300)
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("voiced", [False, True])
def test_decoder_unfused_matches_jax(voiced):
    """1e-5 with unvoiced F0; PARITY.md's envelope with voiced F0."""
    params, m, mp = tiny_decoder()
    asr, f0, n, s, lengths = decoder_inputs(5, voiced=voiced)
    key = jax.random.PRNGKey(195)
    theirs = np.asarray(jax_decoder(False)(params, *(jnp.asarray(v) for v in (
        asr, f0, n, s, lengths)), key))
    with torch.no_grad():
        ours = hifigan.decoder_apply(m, t_(asr), t_(f0), t_(n), t_(s),
                                     lengths=torch.from_numpy(lengths),
                                     source_noise=t_(dither(key, 2, 40))).numpy()
    assert ours.shape == theirs.shape == (2, 1, 40 * 300)
    if voiced:
        for w_t, w_j in zip(ours[:, 0], theirs[:, 0]):
            parity_envelope(w_j, w_t)
    else:
        np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


def test_decoder_fused_matches_jax_fused():
    """The port's fused decoder (K2's plain round on the CPU, chained
    statistics) against the JAX fused decoder, its Pallas round in interpret
    mode, at 2e-4 (tests/test_mrf_fused.py's tolerance for fused against
    unfused), and against the port's unfused decoder at the same bound."""
    params, m, mp = tiny_decoder()
    asr, f0, n, s, lengths = decoder_inputs(3, voiced=False)
    key = jax.random.PRNGKey(7)
    j_fused.set_mrf_round_impl("interpret")
    try:
        theirs = np.asarray(jax_decoder(True)(params, *(jnp.asarray(v) for v in (
            asr, f0, n, s, lengths)), key))
    finally:
        j_fused.set_mrf_round_impl("auto")
    with torch.no_grad():
        args = (t_(asr), t_(f0), t_(n), t_(s))
        kw = dict(lengths=torch.from_numpy(lengths), source_noise=t_(dither(key, 2, 40)))
        ours = hifigan.decoder_apply(m, *args, fused=True, **kw).numpy()
        plain = hifigan.decoder_apply(m, *args, fused=False, **kw).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(ours, plain, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("u,k", [(10, 20), (5, 10), (3, 6), (2, 4)])
def test_odd_rate_transposed_convs(u, k):
    """Each upsampling stage is exactly u x its input: the odd rates take
    padding u // 2 + 1 and an output padding of 1, as in JAX."""
    rng = np.random.default_rng(u)
    x, w, bias = rnd(rng, 2, 6, 13), rnd(rng, 6, 4, k, scale=0.3), rnd(rng, 4)
    kw = dict(stride=u, padding=u // 2 + u % 2, output_padding=u % 2)
    ours = conv_transpose1d(t_(x), t_(w), t_(bias), **kw).numpy()
    theirs = np.asarray(j_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(bias), **kw))
    assert ours.shape == theirs.shape == (2, 4, 13 * u)
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


def test_init_reference_covers_the_hifigan_leaves():
    """Snake alphas are ones; the MRF and noise resblocks' convs and
    ``conv_post`` are HiFi-GAN's N(0, 0.01); weight_g = ||weight_v||."""
    _, m, _ = tiny_decoder()
    nets = init_reference_(torch.nn.ModuleDict({"decoder": hifigan.Decoder(
        m.generator.cfg, DIM_IN, 16, WIDTH, ASR_RES)}), torch.Generator().manual_seed(0))
    gen = nets["decoder"].generator
    assert len(gen.alphas) == 5
    for a, c in zip(gen.alphas, (32, 16, 8, 4, 2)):
        assert tuple(a.shape) == (1, c, 1) and torch.equal(a, torch.ones_like(a))
    convs = [gen.conv_post] + [c for blk in list(gen.resblocks) + list(gen.noise_res)
                               for c in list(blk.convs1) + list(blk.convs2)]
    v = torch.cat([c.weight_v.reshape(-1) for c in convs])
    assert abs(float(v.std()) - 0.01) < 0.001 and abs(float(v.mean())) < 0.001
    for c in convs:
        torch.testing.assert_close(c.weight_g, torch.linalg.vector_norm(
            c.weight_v, dim=(1, 2), keepdim=True))


def test_load_jax_params_round_trip_of_a_libritts_zoo():
    """The JAX package's whole multispeaker HiFi-GAN zoo (its 13 nets, the
    tiny config of styletts2_tpu/testing.py) loads into ``build_nets``'
    nets with ``strict=True`` and exports back unchanged."""
    jmp = tiny_model_params(multispeaker=True, decoder_type="hifigan")
    plbert = dict(vocab_size=179, embedding_size=8, hidden_size=24, num_attention_heads=2,
                  intermediate_size=32, max_position_embeddings=64, num_hidden_layers=1)
    asr = dict(hidden_dim=32, n_layers=1, n_token=179, token_embedding_dim=16,
               location_kernel_size=7)
    jdc = dict(lstm_hidden=8, lstm_layers=1)
    zoo = materialize_params(jax.eval_shape(lambda k: build_zoo(
        k, jmp, JPLBertConfig(**plbert), JASRConfig(**asr), JJDCConfig(**jdc),
        include_slm=False, decoder_width=WIDTH, decoder_asr_res_ch=ASR_RES),
        jax.random.PRNGKey(0)), seed=1)
    mp = _build(ModelParams, dataclasses.asdict(jmp))
    assert mp.multispeaker and mp.decoder.type == "hifigan"
    nets = load_jax_params(build_nets(mp, PLBertConfig(**plbert), decoder_width=WIDTH,
                                      decoder_asr_res_ch=ASR_RES, nets=tuple(zoo),
                                      asr_cfg=ASRConfig(**asr), jdc_cfg=JDCConfig(**jdc)),
                           zoo)
    assert len(nets) == 13
    back, want = flatten(export_params(nets)), flatten(zoo)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
