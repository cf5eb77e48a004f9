"""The PyTorch port's tensor primitives against the JAX package's, on the CPU.

Each test makes its inputs with numpy from a seed, runs the JAX function and
its port on the same values, and compares in f32 at 1e-5 (conftest pins JAX
matmuls to full f32 precision).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.nn import conv as jconv
from styletts2_tpu.nn import lstm as jlstm
from styletts2_tpu.nn import norm as jnorm
from styletts2_tpu.nn.activations import gelu_new as j_gelu_new
from styletts2_tpu.nn.activations import leaky_relu as j_leaky_relu
from styletts2_tpu.nn.activations import sin2pi as j_sin2pi
from styletts2_tpu.nn.activations import snake as j_snake
from styletts2_tpu.nn.param_norm import weight_norm_kernel as j_weight_norm
from styletts2_tpu_torch.models import common as cm
from styletts2_tpu_torch.nn import conv as tconv
from styletts2_tpu_torch.nn import norm as tnorm
from styletts2_tpu_torch.nn.activations import gelu_new, leaky_relu, sin_turns, snake
from styletts2_tpu_torch.nn.lstm import bilstm
from styletts2_tpu_torch.nn.param_norm import weight_norm_kernel

torch.set_num_threads(1)

ATOL = 1e-5


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(theirs, ours, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(ours.detach() if isinstance(ours, torch.Tensor)
                                          else ours),
                               np.asarray(theirs), atol=atol, rtol=rtol)


@pytest.mark.parametrize("stride,pad,dil,groups", [
    (1, 0, 1, 1), (2, 1, 1, 1), (1, 5, 5, 1), (1, 3, 3, 4), (2, 1, 1, 8)])
def test_conv1d(stride, pad, dil, groups):
    rng = np.random.default_rng(0)
    x, w, b = rnd(rng, 2, 8, 37), rnd(rng, 16, 8 // groups, 3), rnd(rng, 16)
    j = jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                     padding=pad, dilation=dil, groups=groups)
    t = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                     stride=stride, padding=pad, dilation=dil, groups=groups)
    close(j, t)


@pytest.mark.parametrize("c_in,c_out,k,stride,pad,outpad,groups", [
    (8, 4, 20, 10, 5, 0, 1), (6, 3, 12, 6, 3, 0, 1), (5, 5, 3, 2, 1, 1, 5),
    (8, 8, 4, 2, 1, 1, 2)])
def test_conv_transpose1d(c_in, c_out, k, stride, pad, outpad, groups):
    rng = np.random.default_rng(1)
    x, w, b = rnd(rng, 2, c_in, 13), rnd(rng, c_in, c_out // groups, k), rnd(rng, c_out)
    j = jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=stride, padding=pad, output_padding=outpad,
                               groups=groups)
    t = tconv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), stride=stride, padding=pad,
                               output_padding=outpad, groups=groups)
    close(j, t)


def test_interpolate_nearest_2x():
    x = rnd(np.random.default_rng(2), 2, 3, 11)
    close(jconv.interpolate_nearest_2x(jnp.asarray(x)),
          tconv.interpolate_nearest_2x(torch.from_numpy(x)), atol=0)


@pytest.mark.parametrize("shape", [(6, 3, 5), (4, 2, 3)])
def test_weight_norm(shape):
    """Conv (out, in, K) and conv-transpose (in, out, K) kernels alike: the
    norm is over every dim but 0."""
    rng = np.random.default_rng(3)
    v, g = rnd(rng, *shape), rnd(rng, shape[0], 1, 1)
    close(j_weight_norm({"weight_v": jnp.asarray(v), "weight_g": jnp.asarray(g)}),
          weight_norm_kernel(torch.from_numpy(v), torch.from_numpy(g)))
    m = cm.WNConv1d(shape[1], shape[0], shape[2])
    assert sorted(m.state_dict()) == ["bias", "weight_g", "weight_v"]
    assert tuple(m.weight_g.shape) == (shape[0], 1, 1)


def test_layer_norms():
    rng = np.random.default_rng(4)
    x, g, b = rnd(rng, 2, 5, 7, scale=3.0), rnd(rng, 7), rnd(rng, 7)
    close(jnorm.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)),
          tnorm.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)))
    xc, gc, bc = rnd(rng, 2, 6, 9), rnd(rng, 6), rnd(rng, 6)
    close(jnorm.layer_norm_channels(jnp.asarray(xc), jnp.asarray(gc), jnp.asarray(bc)),
          tnorm.layer_norm(torch.from_numpy(xc), torch.from_numpy(gc),
                           torch.from_numpy(bc), dim=1))


@pytest.mark.parametrize("masked", [False, True])
def test_instance_norm_and_adain(masked):
    rng = np.random.default_rng(5)
    x, s = rnd(rng, 3, 4, 20, scale=2.0), rnd(rng, 3, 6)
    keep = np.arange(20)[None, :] < np.array([20, 13, 5])[:, None]
    m = cm.StyleAffine(6, 4)
    with torch.no_grad():
        m.fc.weight.copy_(torch.from_numpy(rnd(rng, 8, 6, scale=0.3)))
        m.fc.bias.copy_(torch.from_numpy(rnd(rng, 8, scale=0.3)))
    jp = {"fc": {"weight": jnp.asarray(m.fc.weight.detach().numpy()),
                 "bias": jnp.asarray(m.fc.bias.detach().numpy())}}
    jk = jnp.asarray(keep) if masked else None
    tk = torch.from_numpy(keep) if masked else None
    if masked:
        close(jnorm.masked_instance_norm1d(jnp.asarray(x), jk),
              tnorm.masked_instance_norm1d(torch.from_numpy(x), tk))
    else:
        close(jnorm.instance_norm(jnp.asarray(x)), tnorm.instance_norm(torch.from_numpy(x)))
    close(jnorm.adain1d(jp, jnp.asarray(x), jnp.asarray(s), keep=jk),
          tnorm.adain1d(m, torch.from_numpy(x), torch.from_numpy(s), keep=tk))
    xt = np.swapaxes(x, 1, 2).copy()                       # (B, T, C) for AdaLayerNorm
    close(jnorm.ada_layer_norm(jp, jnp.asarray(xt), jnp.asarray(s)),
          tnorm.ada_layer_norm(m, torch.from_numpy(xt), torch.from_numpy(s)))


def test_bilstm_packed_semantics():
    """The reverse direction starts at each sample's true end; pad steps are 0
    (mirrors tests/test_nn_primitives.py::test_bilstm_packed_semantics)."""
    torch.manual_seed(2)
    lstm = cm.lstm(6, 5)
    x = rnd(np.random.default_rng(6), 4, 12, 6)
    lengths = np.array([12, 7, 3, 9])
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in lstm.state_dict().items()}
    theirs = jlstm.bilstm(params, jnp.asarray(x), jnp.asarray(lengths))
    ours = bilstm(lstm, torch.from_numpy(x), torch.from_numpy(lengths))
    close(theirs, ours)
    assert float(ours[2, 3:].abs().max()) == 0.0
    close(jlstm.bilstm(params, jnp.asarray(x)), bilstm(lstm, torch.from_numpy(x)))


def test_activations():
    """Exact torch.sin against the JAX package's polynomials (~6e-7)."""
    rng = np.random.default_rng(7)
    x = rnd(rng, 2, 4, 33, scale=3.0)
    a = np.abs(rnd(rng, 1, 4, 1)) + 0.5
    close(j_leaky_relu(jnp.asarray(x), 0.2), leaky_relu(torch.from_numpy(x), 0.2))
    close(j_snake(jnp.asarray(x), jnp.asarray(a)), snake(torch.from_numpy(x), torch.from_numpy(a)))
    close(j_gelu_new(jnp.asarray(x)), gelu_new(torch.from_numpy(x)))
    r = np.cumsum(np.abs(rnd(rng, 1000)) * 0.2).astype(np.float32)   # ~1e2 turns
    close(j_sin2pi(jnp.asarray(r)), sin_turns(torch.from_numpy(r)), atol=1e-4)
