"""The port's monotonic maximum path (kernels/maximum_path.py, K3) against
the JAX package: bit-exact, on the CPU, with ``ops/monotonic.py::
maximum_path`` and with the Pallas kernel ``maximum_path_pallas`` in
interpret mode, over several seeds, ties and ``text_len == mel_len``.  The
CUDA kernel is held against the plain version by the test marked ``cuda``,
which skips without a GPU, and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.ops.monotonic import maximum_path as j_maximum_path
from styletts2_tpu.ops.pallas.monotonic_kernel import maximum_path_pallas
from styletts2_tpu_torch.kernels import maximum_path as K
from styletts2_tpu_torch.ops.monotonic import maximum_path as t_maximum_path

torch.set_num_threads(1)


def cases(seed):
    """(values, text_lengths, mel_lengths): random scores with mixed lengths,
    and with ``tie`` quantised scores (many equal sums)."""
    rng = np.random.default_rng(seed)
    b, t_text, t_mel = 4, 16, 24
    values = rng.standard_normal((b, t_text, t_mel)).astype(np.float32)
    if seed % 2:
        values = np.round(values * 2) / 2          # ties
    tl = np.array([16, 9, 12, 5], np.int32)
    ml = np.array([24, 15, 12, 5], np.int32)       # rows 2 and 3: text_len == mel_len
    return values, tl, ml


def jax_paths(values, tl, ml):
    args = (jnp.asarray(values), jnp.asarray(tl), jnp.asarray(ml))
    return np.asarray(j_maximum_path(*args)), np.asarray(maximum_path_pallas(*args,
                                                                             interpret=True))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_and_wrapper_bit_exact_with_jax(seed):
    values, tl, ml = cases(seed)
    scan, pallas = jax_paths(values, tl, ml)
    np.testing.assert_array_equal(scan, pallas)
    launches = K.launches
    plain = K.maximum_path_plain(torch.from_numpy(values), torch.from_numpy(tl),
                                 torch.from_numpy(ml)).numpy()
    wrapped = t_maximum_path(torch.from_numpy(values), torch.from_numpy(tl),
                             torch.from_numpy(ml).long()).numpy()
    assert K.launches == launches                  # the CPU takes the plain version
    np.testing.assert_array_equal(plain, scan)
    np.testing.assert_array_equal(wrapped, scan)
    # one token per valid frame, none past the lengths
    for i in range(len(tl)):
        assert (plain[i].sum(0)[: ml[i]] == 1).all() and not plain[i][:, ml[i]:].any()
        assert not plain[i][tl[i]:].any()


def test_soft_alignment_shape_of_training():
    """Masked soft-attention-like scores in [0, 1) (what stage 1 feeds it),
    with zeros past the lengths, as in compute_alignment."""
    rng = np.random.default_rng(7)
    b, t_text, t_mel = 3, 12, 40
    tl, ml = np.array([12, 7, 10], np.int32), np.array([40, 22, 10], np.int32)
    soft = rng.random((b, t_text, t_mel)).astype(np.float32)
    soft *= (np.arange(t_text)[None, :, None] < tl[:, None, None])
    soft *= (np.arange(t_mel)[None, None, :] < ml[:, None, None])
    scan, _ = jax_paths(soft, tl, ml)
    ours = K.maximum_path(torch.from_numpy(soft), torch.from_numpy(tl), torch.from_numpy(ml))
    np.testing.assert_array_equal(ours.numpy(), scan)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    values, tl, ml = (torch.from_numpy(a) for a in cases(0))
    with pytest.raises(ValueError):
        K.maximum_path(values, tl.long(), ml)
    with pytest.raises(TypeError):
        K.maximum_path(values.double(), tl, ml)
    with pytest.raises(RuntimeError):
        K.maximum_path(values.clone().requires_grad_(), tl, ml)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_on_gpu(seed):
    """The stage-1 width (16, 128, 104), mixed lengths, ties on odd seeds:
    exactly equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(seed)
    b, t_text, t_mel = 16, 128, 104
    values = rng.random((b, t_text, t_mel)).astype(np.float32)
    if seed % 2:
        values = np.round(values * 4) / 4
    tl = rng.integers(20, t_text + 1, b).astype(np.int32)
    ml = np.maximum(tl, rng.integers(20, t_mel + 1, b)).astype(np.int32).clip(max=t_mel)
    tl = np.minimum(tl, ml)
    tl[0] = ml[0]
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (values, tl, ml)]
    launches = K.launches
    got = K.maximum_path(*args)
    torch.cuda.synchronize()
    assert K.launches == launches + 1
    assert torch.equal(got, K.maximum_path_plain(*args))
