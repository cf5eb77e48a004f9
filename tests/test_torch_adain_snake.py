"""The port's AdaIN -> Snake (kernels/adain_snake.py, K1f and K1b) against
the JAX package.

On the CPU the wrapper runs its plain version: it is held against the Pallas
kernel ``adain_snake_pallas`` in interpret mode and against the JAX
package's XLA composition (``ops/fused.py::adain_snake``), forward at 1e-5
and gradients at 1e-4 (the tolerances of
tests/test_pallas_kernels.py::TestAdainSnakeKernel).  The closed-form
backward ``adain_snake_bwd_plain`` is held against torch autograd of the
plain forward and against ``jax.grad`` through the Pallas VJP.  The CUDA
kernels are held against the plain versions by the tests marked ``cuda``,
which skip without a GPU, and by chip_smoke.py; the one numerical change of
the kernels' backward (one sincos per frame) is held here on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.ops import fused as j_fused
from styletts2_tpu.ops.pallas.adain_snake_kernel import adain_snake_pallas
from styletts2_tpu_torch.kernels import adain_snake as K
from styletts2_tpu_torch.models.common import StyleAffine
from styletts2_tpu_torch.ops.fused import adain_snake as t_adain_snake

torch.set_num_threads(1)


def inputs(seed, b=2, c=16, t=96, masked=True):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.standard_normal((b, c, t)).astype(f),
                gamma=(0.3 * rng.standard_normal((b, c))).astype(f),
                beta=(0.3 * rng.standard_normal((b, c))).astype(f),
                alpha=(1.0 + 0.3 * rng.standard_normal(c)).astype(f),
                dy=rng.standard_normal((b, c, t)).astype(f),
                lengths=np.array([t, t // 2, 7][:b], np.int32) if masked else None)


def jax_pallas(a):
    """y and the (x, gamma, beta, alpha) gradients of sum(y * dy) through
    the Pallas kernel and its VJP, in interpret mode."""
    b, _, t = a["x"].shape
    lens = jnp.asarray(a["lengths"] if a["lengths"] is not None else np.full(b, t, np.int32))

    def loss(x, g, be, al):
        y = adain_snake_pallas(x, g, be, al, lens, True)
        return jnp.sum(y * a["dy"]), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a[k]) for k in ("x", "gamma", "beta", "alpha")))
    return np.asarray(y), [np.asarray(g) for g in grads]


def torch_plain(a):
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in ("x", "gamma", "beta", "alpha")]
    lengths = None if a["lengths"] is None else torch.from_numpy(a["lengths"])
    y = K.adain_snake(*leaves, lengths)
    (y * torch.from_numpy(a["dy"])).sum().backward()
    return y.detach().numpy(), [p.grad.numpy() for p in leaves]


def grads_close(got, want, names=("dx", "dgamma", "dbeta", "dalpha")):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("masked", [True, False])
def test_plain_and_autograd_match_pallas(masked):
    a = inputs(0, b=3, masked=masked)
    y_j, g_j = jax_pallas(a)
    launches = (K.fwd_launches, K.bwd_launches)
    y_t, g_t = torch_plain(a)
    assert (K.fwd_launches, K.bwd_launches) == launches     # the CPU takes the plain version
    np.testing.assert_allclose(y_t, y_j, atol=1e-5, rtol=1e-5)
    grads_close(g_t, g_j)


@pytest.mark.parametrize("masked", [True, False])
def test_closed_form_backward_matches_autograd_and_pallas(masked):
    a = inputs(1, b=3, t=120, masked=masked)
    _, g_j = jax_pallas(a)
    _, g_auto = torch_plain(a)
    x, gamma, beta, alpha, dy = (torch.from_numpy(a[k])
                                 for k in ("x", "gamma", "beta", "alpha", "dy"))
    lengths = None if a["lengths"] is None else torch.from_numpy(a["lengths"])
    mean, rstd = K.mean_rstd_plain(x, lengths)
    dx, dg, db, da_rows = K.adain_snake_bwd_plain(x, gamma, beta, alpha, mean, rstd,
                                                  lengths, dy)
    closed = [dx, dg, db, da_rows.sum(0)]
    grads_close(closed, g_auto)
    grads_close(closed, g_j)


@pytest.mark.parametrize("masked", [True, False])
def test_call_site_matches_jax_composition(masked):
    """``ops/fused.py::adain_snake`` (style projection included) against the
    JAX package's XLA composition, with gradients to x, the projection and
    alpha."""
    rng = np.random.default_rng(3)
    b, c, t, sdim = 2, 16, 96, 8
    x, s = rng.standard_normal((b, c, t)).astype(np.float32), \
        rng.standard_normal((b, sdim)).astype(np.float32)
    w = (0.2 * rng.standard_normal((2 * c, sdim))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(2 * c)).astype(np.float32)
    alpha = (1.0 + 0.3 * rng.standard_normal((1, c, 1))).astype(np.float32)
    lengths = np.array([t, t // 2], np.int32) if masked else None
    cot = np.cos(np.arange(t)).astype(np.float32)

    def loss(x_, p, al):
        y = j_fused.adain_snake(p, x_, jnp.asarray(s), al,
                                lengths=None if lengths is None else jnp.asarray(lengths))
        return (y * cot).sum(), y

    (_, y_j), (gx, gp, ga) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), {"fc": {"weight": jnp.asarray(w), "bias": jnp.asarray(bias)}},
        jnp.asarray(alpha))
    m = StyleAffine(sdim, c)
    m.fc.weight.data, m.fc.bias.data = torch.from_numpy(w), torch.from_numpy(bias)
    xt, at = torch.from_numpy(x).requires_grad_(), torch.from_numpy(alpha).requires_grad_()
    y_t = t_adain_snake(m, xt, torch.from_numpy(s), at,
                        None if lengths is None else torch.from_numpy(lengths))
    (y_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    grads_close([xt.grad, m.fc.weight.grad, m.fc.bias.grad, at.grad],
                [np.asarray(g) for g in (gx, gp["fc"]["weight"], gp["fc"]["bias"], ga)],
                ("dx", "dW", "db", "dalpha"))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = {k: (torch.from_numpy(v) if v is not None else None) for k, v in inputs(4).items()}
    args = (a["x"], a["gamma"], a["beta"], a["alpha"])
    with pytest.raises(ValueError):                        # int64 lengths
        K.adain_snake(*args, a["lengths"].long())
    with pytest.raises(TypeError):                         # f64 input
        K.adain_snake(a["x"].double(), *args[1:], a["lengths"])
    with pytest.raises(ValueError):                        # non-contiguous gamma
        K.adain_snake(a["x"], a["gamma"].t().contiguous().t(), *args[2:], a["lengths"])
    with pytest.raises(ValueError):                        # alpha of the wrong length
        K.adain_snake(*args[:3], a["alpha"][:-1], a["lengths"])
    with pytest.raises(ValueError):                        # no kernel for the CPU
        K.adain_snake_fwd(*args, a["lengths"])


def test_sincos_form_keeps_k1b_accuracy():
    """K1b's kernels take one sincos per frame, sin(2au) = 2 sin(au) cos(au):
    its closed form so written, in f32, against the closed form with
    sin(2au) (``adain_snake_bwd_plain``), within 1e-5 of each leaf's largest
    gradient, at |alpha u| above 30 (beyond the training shapes' ~10)."""
    a = inputs(6, b=3, c=16, t=4096)
    x, gamma, beta, alpha, dy = (torch.from_numpy(a[k])
                                 for k in ("x", "gamma", "beta", "alpha", "dy"))
    gamma, alpha = 4.0 * gamma, 1.5 * alpha            # widen |alpha u|
    lengths = torch.from_numpy(a["lengths"])
    mean, rstd = K.mean_rstd_plain(x, lengths)
    t = x.shape[-1]
    g1, be, al = (1.0 + gamma)[:, :, None], beta[:, :, None], alpha[None, :, None]
    xh = (x - mean[:, :, None]) * rstd[:, :, None]
    u = g1 * xh + be
    assert float((al * u).abs().max()) > 30.0
    sn, cs = torch.sin(al * u), torch.cos(al * u)
    s2 = 2.0 * sn * cs
    du = dy * (1.0 + s2)
    dxh = du * g1
    keep = torch.arange(t)[None, None, :] < lengths[:, None, None]
    n = torch.clamp(lengths, min=1).to(x.dtype)[:, None, None]
    corr = (dxh.sum(-1, keepdim=True) + xh * (dxh * xh).sum(-1, keepdim=True)) / n
    sincos = [rstd[:, :, None] * (dxh - torch.where(keep, corr, torch.zeros_like(corr))),
              (du * xh).sum(-1), du.sum(-1),
              (dy * (u * s2 / al - sn * sn / (al * al))).sum(-1)]
    ref = K.adain_snake_bwd_plain(x, gamma, beta, alpha, mean, rstd, lengths, dy)
    for got, want, name in zip(sincos, ref, ("dx", "dgamma", "dbeta", "dalpha")):
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        assert err <= 1e-5 * scale, f"{name}: {err} > 1e-5 * {scale}"


# (B, C, T), the paths of K1f and K1b (``adain_snake.plan``) and the offset,
# in floats, of x and dy from a 16-byte boundary: the stage-1 decoder's two
# row lengths, then small rows that cover every instantiation and both
# long-row forms, with T = 0, 1, 2 and 3 mod 4 (rows starting off a 16-byte
# boundary), and inputs that are views one float into their storage (the
# wrapper copies them to an aligned base); then the HiFi-GAN decoder's long
# rows in LibriTTS training: its 64- and 32-channel stages at a clip of 96
# aligner frames, the last row length the shared-memory cache holds on an
# H100 ((232448 - 1024) / 4 = 57856 frames of its opt-in limit) and the
# first it re-reads through L2, and the 32-channel stage at
# configs/libritts.yml's max_len 300.
GPU_CASES = [
    ((4, 256, 1920), "rows 128x4", "rows 128x4", 0),
    ((2, 128, 11521), "rows 384x8", "rows 768x4", 0),
    ((4, 8, 37), "rows 128x4", "rows 128x4", 0),
    ((4, 8, 1919), "rows 128x4", "rows 128x4", 0),
    ((4, 8, 4002), "rows 256x4", "rows 256x4", 0),
    ((4, 8, 16003), "rows 1024x6", "rows 1024x4", 0),
    ((4, 8, 24001), "rows 1024x6", "long, shared-memory cache", 0),
    ((4, 8, 30002), "long, shared-memory cache", "long, shared-memory cache", 0),
    ((4, 8, 60001), "long, L2 re-read", "long, L2 re-read", 0),
    ((4, 8, 1921), "rows 128x4", "rows 128x4", 1),
    ((4, 64, 28800), "long, shared-memory cache", "long, shared-memory cache", 0),
    ((4, 32, 57600), "long, shared-memory cache", "long, shared-memory cache", 0),
    ((4, 32, 57856), "long, shared-memory cache", "long, shared-memory cache", 0),
    ((4, 32, 57857), "long, L2 re-read", "long, L2 re-read", 0),
    ((4, 32, 90000), "long, L2 re-read", "long, L2 re-read", 0),
]


def at_offset(a: torch.Tensor, offset: int) -> torch.Tensor:
    """``a``'s values in a contiguous view ``offset`` floats into a buffer."""
    if offset == 0:
        return a
    buf = torch.empty(a.numel() + offset, dtype=a.dtype, device=a.device)
    view = buf[offset:].view(a.shape)
    view.copy_(a)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fwd_path,bwd_path,offset", GPU_CASES)
@pytest.mark.parametrize("masked", [True, False])
def test_kernels_match_plain_on_gpu(shape, fwd_path, bwd_path, offset, masked):
    """K1f against adain_snake_plain (1e-5 * max|y|), K1b against the closed
    form and autograd of the plain forward (1e-4 * max|grad|), on the path
    each T takes; masked rows have lengths T, inside the row, 0 and 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    b, c, t = shape
    assert (K.plan(t), K.plan(t, backward=True)) == (fwd_path, bwd_path)
    dev = torch.device("cuda")
    a = {k: (torch.from_numpy(v).to(dev) if v is not None else None)
         for k, v in inputs(5, b, c, t, masked).items()}
    if masked:
        a["lengths"] = torch.tensor([t, t * 3 // 5, 0, 1][:b], dtype=torch.int32, device=dev)
    a["x"], a["dy"] = at_offset(a["x"], offset), at_offset(a["dy"], offset)
    assert (a["x"].data_ptr() % 16 == 0) == (offset == 0)
    args = (a["x"], a["gamma"], a["beta"], a["alpha"], a["lengths"])
    fwd, bwd = K.fwd_launches, K.bwd_launches
    y, mean, rstd = K.adain_snake_fwd(*args)
    torch.cuda.synchronize()
    assert K.fwd_launches == fwd + 1
    y_ref = K.adain_snake_plain(*args)
    assert float((y - y_ref).abs().max()) <= 1e-5 * float(y_ref.abs().max())
    got = K.adain_snake_bwd(*args[:4], mean, rstd, a["lengths"], a["dy"])
    torch.cuda.synchronize()
    assert K.bwd_launches == bwd + 1
    ref = K.adain_snake_bwd_plain(*args[:4], mean, rstd, a["lengths"], a["dy"])
    leaves = [t_.clone().requires_grad_() for t_ in args[:4]]
    (K.adain_snake_plain(*leaves, a["lengths"]) * a["dy"]).sum().backward()
    auto = [p.grad for p in leaves]
    for g, r, au in zip(got[:3], ref[:3], auto[:3]):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())
        assert float((g - au).abs().max()) <= 1e-4 * float(au.abs().max())
    da = got[3].sum(0)
    assert float((da - auto[3]).abs().max()) <= 1e-4 * float(auto[3].abs().max())
