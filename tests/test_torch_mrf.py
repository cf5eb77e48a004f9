"""The port's fused MRF round (kernels/mrf_round.py) against the JAX package.

On the CPU the wrapper runs its plain version; it is held against the Pallas
kernel ``fused_mrf_round`` in interpret mode, and the resblock and generator
built on it against the JAX compositions.  The CUDA kernel itself is held
against the plain version by the test marked ``cuda``, which skips without a
GPU, and by chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from styletts2_tpu.models.decoder import istftnet as j_istftnet
from styletts2_tpu.models.decoder.resblock import (
    adain_resblock1_apply as j_resblock_apply, init_adain_resblock1)
from styletts2_tpu.ops.pallas.mrf_round_kernel import (
    fused_mrf_round, masked_stats_guarded, pack_guarded, pack_plane,
    stats_from_partials as j_stats_from_partials, unpack_guarded)
from styletts2_tpu.testing import tiny_model_params
from styletts2_tpu_torch.kernels import mrf_round as K
from styletts2_tpu_torch.models.decoder.istftnet import Decoder, decoder_apply
from styletts2_tpu_torch.models.decoder.resblock import (
    AdainResBlock1, adain_resblock1_apply, adain_resblock1_fused)
from styletts2_tpu_torch.models.zoo import flatten
from styletts2_tpu_torch.nn.activations import snake

torch.set_num_threads(1)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def load(module, jax_tree):
    module.load_state_dict({k: t_(v) for k, v in flatten(jax_tree).items()}, strict=True)
    return module


def round_inputs(seed, b, c, t, k, lengths):
    rng = np.random.default_rng(seed)
    return dict(
        x=rnd(rng, b, c, t), gamma=rnd(rng, b, c, scale=0.1), beta=rnd(rng, b, c, scale=0.1),
        alpha=(np.abs(rnd(rng, c)) + 0.5).astype(np.float32), w=rnd(rng, c, c, k, scale=0.05),
        bias=rnd(rng, c, scale=0.1), residual=rnd(rng, b, c, t),
        lengths=np.asarray(lengths, np.int32))


@pytest.mark.parametrize("with_residual", [False, True])
def test_round_plain_matches_pallas(with_residual):
    """Shapes of tests/test_mrf_fused.py: y at 2e-5, chained (mean, rstd) at
    1e-5 / 1e-4."""
    b, c, t, k, d, t_blk = 3, 16, 200, 7, 3, 48
    a = round_inputs(0, b, c, t, k, [t, 150, 64])
    lengths = jnp.asarray(a["lengths"])
    x_pad = pack_guarded(jnp.asarray(a["x"]), t_blk)
    mean, rstd = masked_stats_guarded(x_pad, lengths, t_blk, t)
    y_pad, parts = fused_mrf_round(
        x_pad, pack_plane(mean, rstd, jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]),
                          jnp.asarray(a["alpha"]), jnp.asarray(a["bias"])),
        jnp.transpose(jnp.asarray(a["w"]), (2, 1, 0)), lengths, k=k, d=d, t_blk=t_blk,
        t=t, residual=pack_guarded(jnp.asarray(a["residual"]), t_blk) if with_residual
        else None, emit_stats=True, interpret=True)
    j_y = unpack_guarded(y_pad, t_blk, t)
    j_mean, j_rstd = j_stats_from_partials(parts, lengths, t)

    tl = torch.from_numpy(a["lengths"])
    t_mean, t_rstd = K.masked_stats(t_(a["x"]), tl)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_rstd.numpy(), np.asarray(rstd), atol=1e-4, rtol=1e-4)
    launches = K.launches
    y, t_parts = K.mrf_round(
        t_(a["x"]), t_mean, t_rstd, t_(a["gamma"]), t_(a["beta"]), t_(a["alpha"]),
        t_(a["w"]), t_(a["bias"]), tl, k=k, d=d,
        residual=t_(a["residual"]) if with_residual else None)
    assert K.launches == launches                 # the CPU takes the plain version
    assert tuple(t_parts.shape) == (b, K.n_tiles(t), 3, c)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), atol=2e-5, rtol=1e-5)
    m_chain, r_chain = K.stats_from_partials(t_parts, tl, t)
    np.testing.assert_allclose(m_chain.numpy(), np.asarray(j_mean), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(r_chain.numpy(), np.asarray(j_rstd), atol=1e-4, rtol=1e-4)
    # and a fresh masked reduction of y gives the same statistics
    f_mean, f_rstd = K.masked_stats(y, tl)
    np.testing.assert_allclose(m_chain.numpy(), f_mean.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(r_chain.numpy(), f_rstd.numpy(), atol=1e-4, rtol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    b, c, t, k = 2, 8, 40, 3
    a = round_inputs(1, b, c, t, k, [t, 20])
    args = [t_(a["x"]), t_(a["gamma"]), t_(a["gamma"]), t_(a["gamma"]), t_(a["beta"]),
            t_(a["alpha"]), t_(a["w"]), t_(a["bias"]), torch.from_numpy(a["lengths"])]
    with pytest.raises(ValueError):                        # int64 lengths
        K.mrf_round(*args[:-1], args[-1].long(), k=k, d=1)
    with pytest.raises(TypeError):                         # f64 input
        K.mrf_round(args[0].double(), *args[1:], k=k, d=1)
    with pytest.raises(ValueError):                        # non-contiguous gamma
        K.mrf_round(args[0], args[1], args[2], torch.randn(c, b).t(), *args[4:], k=k, d=1)
    with pytest.raises(ValueError):                        # kernel size 5
        K.mrf_round(*args[:6], torch.zeros(c, c, 5), *args[7:], k=5, d=1)
    with pytest.raises(RuntimeError):                      # no backward
        K.mrf_round(*args[:6], args[6].clone().requires_grad_(), *args[7:], k=k, d=1)


@pytest.mark.parametrize("kernel", [3, 11])
def test_fused_resblock_matches_jax(kernel):
    """Six mrf_round calls with chained statistics vs the JAX unfused
    resblock, at 5e-5; the port's unfused resblock at 1e-5."""
    rng = np.random.default_rng(1)
    b, c, t, style, dil = 2, 16, 150, 8, (1, 3, 5)
    p = jax.tree_util.tree_map(np.asarray, init_adain_resblock1(
        jax.random.PRNGKey(0), c, kernel, dil, style))
    m = load(AdainResBlock1(c, kernel, dil, style), p)
    x, s = rnd(rng, b, c, t), rnd(rng, b, style)
    lengths = np.asarray([t, 90], np.int32)
    ref = np.asarray(j_resblock_apply(p, jnp.asarray(x), jnp.asarray(s), kernel, dil,
                                      lengths=jnp.asarray(lengths)))
    with torch.no_grad():
        fused, (mean, rstd) = adain_resblock1_fused(m, t_(x), t_(s), torch.from_numpy(lengths))
        plain = adain_resblock1_apply(m, t_(x), t_(s), torch.from_numpy(lengths))
    np.testing.assert_allclose(fused.numpy(), ref, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(plain.numpy(), ref, atol=1e-5, rtol=1e-5)
    f_mean, f_rstd = K.masked_stats(fused, torch.from_numpy(lengths))
    np.testing.assert_allclose(mean.numpy(), f_mean.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), f_rstd.numpy(), atol=1e-4, rtol=1e-4)


def test_generator_fused_matches_unfused_and_jax():
    """The tiny decoder (tests/test_mrf_fused.py's config): fused vs unfused
    port at 2e-4, and fused port vs JAX at 2e-4 past the first 700 samples.

    Against JAX the harmonic source carries the dither JAX drew, and F0 is
    below the voicing threshold.  The decoder feeds raw atan2 phases of the
    source's STFT to convolutions, so a bin near zero turns ~1e-7 FFT
    rounding into a phase jump: the dither fills every bin, and unvoiced F0
    keeps torch.sin and JAX's sine polynomial out of the source.  STFT frame
    0 is even-symmetric, every bin on the atan2 branch cut, so the first 700
    samples are held to the PARITY.md head bound (0.35) instead.
    """
    mp = tiny_model_params()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda key: j_istftnet.init_decoder(
        key, mp.decoder, dim_in=16, style_dim=mp.style_dim, width=64,
        asr_res_ch=8))(jax.random.PRNGKey(2)))
    m = load(Decoder(mp.decoder, 16, mp.style_dim, 64, 8), params)
    rng = np.random.default_rng(3)
    b, t_en = 2, 20
    asr, n, s = rnd(rng, b, 16, t_en), rnd(rng, b, 2 * t_en), rnd(rng, b, mp.style_dim)
    voiced = np.abs(rnd(rng, b, 2 * t_en)) * 100
    unvoiced = np.abs(rnd(rng, b, 2 * t_en)) * 5
    lengths = np.asarray([t_en, 14], np.int32)
    tl = torch.from_numpy(lengths)
    key = jax.random.PRNGKey(195)
    dither = np.swapaxes(np.asarray(jax.random.normal(
        jax.random.fold_in(key, 1), (b, 2 * t_en * 300, 9))), 1, 2)
    ref = np.asarray(j_istftnet.decoder_apply(
        params, mp.decoder, jnp.asarray(asr), jnp.asarray(unvoiced), jnp.asarray(n),
        jnp.asarray(s), key=key, lengths=jnp.asarray(lengths), fused=False))
    with torch.no_grad():
        args = (t_(asr), t_(voiced), t_(n), t_(s))
        fused = decoder_apply(m, *args, lengths=tl, fused=True)
        plain = decoder_apply(m, *args, lengths=tl, fused=False)
        ours = decoder_apply(m, t_(asr), t_(unvoiced), t_(n), t_(s), lengths=tl,
                             fused=True, source_noise=t_(dither))
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=2e-4, rtol=1e-3)
    assert np.abs(ours.numpy() - ref)[..., :700].max() < 0.35
    np.testing.assert_allclose(ours.numpy()[..., 700:], ref[..., 700:], atol=2e-4, rtol=1e-3)


def tf32(a: torch.Tensor, rounding: str) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits): to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), or by truncation (what the
    kernel's split and the tensor core's read of a TF32 operand do)."""
    bits = a.contiguous().view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
def test_three_tf32_products_keep_f32_accuracy(rounding):
    """The arithmetic of the CUDA kernel's conv, emulated on the CPU at C=128,
    k=11: with a = a_hi + a_lo (a_hi = tf32(a), a_lo = tf32(a - a_hi)) and
    the same for w, the products a_lo*w_hi + a_hi*w_lo + a_hi*w_hi summed in
    f32 are within 1e-5 * max|y| of an f64 conv; one TF32 product a_hi*w_hi
    is not within the card's 1e-4 gate."""
    b, c, t, k, d = 1, 128, 600, 11, 5
    a = round_inputs(5, b, c, t, k, [t])
    x, lengths = t_(a["x"]), torch.from_numpy(a["lengths"])
    mean, rstd = K.masked_stats(x, lengths)
    u = ((1.0 + t_(a["gamma"])[:, :, None]) * ((x - mean[:, :, None]) * rstd[:, :, None])
         + t_(a["beta"])[:, :, None])
    act, w = snake(u, t_(a["alpha"])[None, :, None]), t_(a["w"])
    pad = (k * d - d) // 2
    ref = F.conv1d(act.double(), w.double(), padding=pad, dilation=d)
    scale = float(ref.abs().max())

    a_hi, w_hi = tf32(act, rounding), tf32(w, rounding)
    a_lo, w_lo = tf32(act - a_hi, rounding), tf32(w - w_hi, rounding)
    # one f32 accumulation over the three products of every (ci, tap)
    three = F.conv1d(torch.cat([a_lo, a_hi, a_hi], 1), torch.cat([w_hi, w_lo, w_hi], 1),
                     padding=pad, dilation=d)
    one = F.conv1d(a_hi, w_hi, padding=pad, dilation=d)
    err_three = float((three.double() - ref).abs().max())
    err_one = float((one.double() - ref).abs().max())
    assert err_three <= 1e-5 * scale, (err_three, scale)
    assert err_one > 1e-4 * scale, (err_one, scale)


def bf16_ulp(a: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude ``a``."""
    return 2.0 ** (math.floor(math.log2(a)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("k,d", [(3, 1), (3, 5), (7, 3), (11, 5), (11, 1)])
@pytest.mark.parametrize("c,t", [(256, 2300), (128, 6001), (128, 12001),
                                 (64, 2300), (64, 12001), (32, 2300), (32, 6001),
                                 (32, 12001)])
def test_kernel_matches_plain_on_gpu(c, t, k, d, with_residual, dtype):
    """The CUDA kernel against its plain version on the card at the
    generators' round shapes, batch 3, lengths = T and < T.  f32: y at
    1e-4 * max|y|, chained stats at 1e-4.  bf16 (x, w, residual and y bf16):
    y within 2 bf16 ulps of max|y| (the two sum in other orders in f32, and
    a sum on a rounding boundary may round either way), chained stats at
    1e-3 (of max|y| for the mean).  On 132 SMs the (C, T) of each width take
    the kernel's 64-, 128- and 256-frame tiles; C 64 and 32 its
    one-warpgroup blocks, C 32 with half of their weight rows zero; T=2300
    its 16-byte loads of x, the odd T its 4-byte (f32) or 2-byte (bf16)
    loads; no T is a multiple of a tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    b = 3
    a = round_inputs(4, b, c, t, k, [t, 2 * t // 3, 97])
    dev = torch.device("cuda")
    g = {n: torch.from_numpy(v).to(dev) for n, v in a.items()}
    bf16 = dtype == "bfloat16"
    if bf16:
        for n in ("x", "w", "residual"):
            g[n] = g[n].to(torch.bfloat16)
    mean, rstd = K.masked_stats(g["x"], g["lengths"])
    args = (g["x"], mean, rstd, g["gamma"], g["beta"], g["alpha"], g["w"], g["bias"],
            g["lengths"])
    res = g["residual"] if with_residual else None
    launches, bf16_launches = K.launches, K.bf16_launches
    y, parts = K.mrf_round(*args, k=k, d=d, residual=res)
    torch.cuda.synchronize()
    assert K.launches == launches + 1 and K.bf16_launches == bf16_launches + bf16
    y_ref, parts_ref = K.mrf_round_plain(*args, k=k, d=d, residual=res)
    assert y.dtype == y_ref.dtype == g["x"].dtype
    scale = float(y_ref.abs().max())
    err = float((y.float() - y_ref.float()).abs().max())
    assert err <= (2 * bf16_ulp(scale) if bf16 else 1e-4 * scale), (err, scale)
    tol = dict(atol=1e-3 * scale, rtol=1e-3) if bf16 else dict(atol=1e-4, rtol=1e-4)
    for got, want in zip(K.stats_from_partials(parts, g["lengths"], t),
                         K.stats_from_partials(parts_ref, g["lengths"], t)):
        torch.testing.assert_close(got, want, **tol)
