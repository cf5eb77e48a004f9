"""The port's fused decoders (iSTFTNet, HiFi-GAN) in bf16 against the JAX
package's, on the quieted tiny zoos of test_torch_serve.py.

At fixed inputs, unvoiced F0 and JAX's dither (which keep the source's STFT
phases well conditioned), the port's bf16 decoder (K2's bf16 plain round on
the CPU) is held against the JAX bf16 decoder with its Pallas round in
interpret mode and the JAX f32 decoder: past the first 700 samples
(PARITY.md's head), the port's bf16 wave is no farther from the f32 one
than 1.5x JAX bf16's distance plus 1e-3 (max abs and log-mel L1), and no
farther from JAX bf16's wave than twice that distance (the HiFi-GAN's tanh
output is bf16 itself: these distances are a few of its ulps).
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.audio.mel import log_mel_spectrogram
from styletts2_tpu.models.decoder import hifigan as j_hifigan
from styletts2_tpu.models.decoder import istftnet as j_istftnet
from styletts2_tpu.ops import fused as j_fused
from styletts2_tpu.utils import cast_pytree
from styletts2_tpu_torch.models.decoder import hifigan, istftnet

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_serve import tiny_quiet  # noqa: E402

torch.set_num_threads(1)

HEAD = 700


def _mel(w):
    return np.asarray(log_mel_spectrogram(jnp.asarray(w[None])))


@pytest.mark.parametrize("multispeaker", [False, True])
def test_fused_decoder_bf16_near_jax(multispeaker):
    zoo, nets, jmp, *_ = tiny_quiet(multispeaker)
    j_dec, t_dec = (j_hifigan, hifigan) if multispeaker else (j_istftnet, istftnet)
    rng = np.random.default_rng(5)
    b, t_en, c_in = 2, 12, jmp.hidden_dim
    asr = rng.standard_normal((b, c_in, t_en)).astype(np.float32)
    n = rng.standard_normal((b, 2 * t_en)).astype(np.float32)
    f0 = (np.abs(rng.standard_normal((b, 2 * t_en))) * 5).astype(np.float32)   # unvoiced
    s = (rng.standard_normal((b, jmp.style_dim)) * 0.3).astype(np.float32)
    lengths = np.asarray([t_en, 9], np.int32)
    key = jax.random.PRNGKey(195)
    dither = np.swapaxes(np.asarray(jax.random.normal(
        jax.random.fold_in(key, 1), (b, 2 * t_en * 300, 9))), 1, 2)
    params = jax.tree_util.tree_map(jnp.asarray, zoo["decoder"])

    def decode(p, dtype, fused):
        fn = jax.jit(lambda p, *a: j_dec.decoder_apply(p, jmp.decoder, *a[:4], key=key,
                                                       lengths=a[4], fused=fused))
        return np.asarray(fn(p, *(jnp.asarray(v, dtype) for v in (asr, f0, n, s)),
                             jnp.asarray(lengths)).astype(jnp.float32))

    j32 = decode(params, jnp.float32, False)
    j_fused.set_mrf_round_impl("interpret")
    try:
        j16 = decode(cast_pytree(params, jnp.bfloat16), jnp.bfloat16, True)
    finally:
        j_fused.set_mrf_round_impl("auto")
    m = copy.deepcopy(nets["decoder"]).to(torch.bfloat16)
    with torch.no_grad():
        ours = t_dec.decoder_apply(m, *(torch.from_numpy(v).to(torch.bfloat16)
                                        for v in (asr, f0, n, s)),
                                   lengths=torch.from_numpy(lengths), fused=True,
                                   source_noise=torch.from_numpy(dither)).float().numpy()
    for i in range(b):
        m_ = int(lengths[i]) * 600
        want, theirs, mine = j32[i, 0, :m_], j16[i, 0, :m_], ours[i, 0, :m_]
        assert np.isfinite(mine).all()
        d_jax = np.abs(theirs - want)[HEAD:].max()
        d_ours = np.abs(mine - want)[HEAD:].max()
        assert d_ours <= 1.5 * d_jax + 1e-3, (i, d_ours, d_jax)
        assert np.abs(mine - theirs)[HEAD:].max() <= 2 * d_jax, i
        mel_jax = np.abs(_mel(theirs) - _mel(want)).mean()
        mel_ours = np.abs(_mel(mine) - _mel(want)).mean()
        assert mel_ours <= 1.5 * mel_jax + 1e-3, (i, mel_ours, mel_jax)
