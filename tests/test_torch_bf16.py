"""bf16 serving pieces of the port against the JAX package: the cast of the
nets and K2's bf16 form (kernels/mrf_round.py); the fused decoders in bf16
are in test_torch_bf16_decoder.py, the engines in test_torch_bf16_engine.py.

- ``nets.to(torch.bfloat16)`` after ``load_jax_params`` equals
  ``cast_pytree(zoo, bfloat16)`` leaf for leaf, bitwise.
- K2's bf16 plain version against the Pallas ``fused_mrf_round`` on bf16
  inputs in interpret mode: both round at the same points (the f32
  activation to bf16, y to bf16 after an f32 bias and residual, the
  partials from the rounded y), so y is held within 2 bf16 ulps of max|y|
  (the two sum the products in other orders in f32) and the chained
  statistics at 1e-3.
"""

import copy
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.ops.pallas.mrf_round_kernel import (
    fused_mrf_round, masked_stats_guarded, pack_guarded, pack_plane,
    stats_from_partials as j_stats_from_partials, unpack_guarded)
from styletts2_tpu.utils import cast_pytree
from styletts2_tpu_torch.kernels import mrf_round as K
from styletts2_tpu_torch.models.zoo import flatten

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_mrf import bf16_ulp  # noqa: E402
from test_torch_serve import tiny_quiet  # noqa: E402

torch.set_num_threads(1)

def bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().view(torch.int16).numpy()


@pytest.mark.parametrize("multispeaker", [False, True])
def test_cast_equals_cast_pytree(multispeaker):
    zoo, nets, *_ = tiny_quiet(multispeaker)
    ours = copy.deepcopy(nets).to(torch.bfloat16)
    theirs = cast_pytree(jax.tree_util.tree_map(jnp.asarray, zoo), jnp.bfloat16)
    for name, net in ours.items():
        want = flatten(theirs[name])
        state = net.state_dict()
        assert sorted(state) == sorted(want), name
        for k, v in state.items():
            assert v.dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16, (name, k)
            np.testing.assert_array_equal(bits(v), np.asarray(want[k]).view(np.int16),
                                          err_msg=f"{name}.{k}")


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("c", [128, 32])
def test_round_bf16_plain_matches_pallas(c, with_residual):
    b, t, k, d, t_blk = 2, 150, 7, 3, 48
    rng = np.random.default_rng(c)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x, res = rnd(b, c, t), rnd(b, c, t)
    gamma, beta, bias = rnd(b, c, scale=0.1), rnd(b, c, scale=0.1), rnd(c, scale=0.1)
    alpha = (np.abs(rnd(c)) + 0.5).astype(np.float32)
    w = rnd(c, c, k, scale=1.0 / math.sqrt(c * k))
    lengths = np.asarray([t, 97], np.int32)
    jl, bf = jnp.asarray(lengths), jnp.bfloat16
    x_pad = pack_guarded(jnp.asarray(x, bf), t_blk)
    mean, rstd = masked_stats_guarded(x_pad, jl, t_blk, t)
    y_pad, parts = fused_mrf_round(
        x_pad, pack_plane(mean, rstd, jnp.asarray(gamma), jnp.asarray(beta),
                          jnp.asarray(alpha), jnp.asarray(bias)),
        jnp.transpose(jnp.asarray(w, bf), (2, 1, 0)), jl, k=k, d=d, t_blk=t_blk, t=t,
        residual=pack_guarded(jnp.asarray(res, bf), t_blk) if with_residual else None,
        emit_stats=True, interpret=True)
    assert y_pad.dtype == bf and parts.dtype == jnp.float32
    j_y = np.asarray(unpack_guarded(y_pad, t_blk, t).astype(jnp.float32))
    j_chain = j_stats_from_partials(parts, jl, t)

    tb, tl = torch.bfloat16, torch.from_numpy(lengths)
    xt = torch.from_numpy(x).to(tb)
    t_mean, t_rstd = K.masked_stats(xt, tl)
    assert t_mean.dtype == torch.float32
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_rstd.numpy(), np.asarray(rstd), atol=1e-4, rtol=1e-4)
    launches = (K.launches, K.bf16_launches)
    y, t_parts = K.mrf_round(
        xt, t_mean, t_rstd, torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(alpha), torch.from_numpy(w).to(tb), torch.from_numpy(bias), tl,
        k=k, d=d, residual=torch.from_numpy(res).to(tb) if with_residual else None)
    assert (K.launches, K.bf16_launches) == launches       # the CPU takes the plain version
    assert y.dtype == tb and t_parts.dtype == torch.float32
    scale = float(np.abs(j_y).max())
    err = float(np.abs(y.float().numpy() - j_y).max())
    assert err <= 2 * bf16_ulp(scale), (err, scale)
    chain = K.stats_from_partials(t_parts, tl, t)
    for ours, theirs in zip(chain, j_chain):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-3, rtol=1e-3)
    # the partials are those of the rounded y
    for ours, fresh in zip(chain, K.masked_stats(y, tl)):
        np.testing.assert_allclose(ours.numpy(), fresh.numpy(), atol=1e-5, rtol=1e-4)
