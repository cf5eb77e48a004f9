"""The port's SLM feature loss and its parts against the JAX package's, on
the CPU: ``interpolate_linear``, the 24 kHz -> 16 kHz resampler, the Whisper
log-mel, the Whisper encoder (all its hidden states) at the tiny test
config, and ``slm_feature_loss`` with its gradient to the generated
waveform.  Tolerance ~1e-5 relative in f32 unless noted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.audio import resample as j_resample
from styletts2_tpu.losses import slm as j_slm
from styletts2_tpu.models import whisper as j_whisper
from styletts2_tpu.nn import conv as j_conv
from styletts2_tpu.testing import tiny_whisper_cfg
from styletts2_tpu.utils import materialize_params
from styletts2_tpu_torch.audio import resample as t_resample
from styletts2_tpu_torch.losses import slm as t_slm
from styletts2_tpu_torch.models import whisper as t_whisper
from styletts2_tpu_torch.models.zoo import build_nets, flatten, load_jax_params
from styletts2_tpu_torch.config import ModelParams
from styletts2_tpu_torch.nn import conv as t_conv

torch.set_num_threads(1)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(theirs, ours, atol=1e-5, rtol=1e-5):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol)


@functools.lru_cache(maxsize=None)
def tiny_encoder():
    """(JAX tree as numpy, JAX config, the port's encoder with it loaded)."""
    jcfg = tiny_whisper_cfg()
    tree = materialize_params(jax.eval_shape(
        lambda k: j_whisper.init_whisper_encoder(k, jcfg), jax.random.PRNGKey(0)), seed=3)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    cfg = t_whisper.WhisperConfig(**jcfg.__dict__)
    nets = load_jax_params(build_nets(ModelParams(), nets=("slm_encoder",), whisper_cfg=cfg),
                           {"slm_encoder": tree})
    return tree, jcfg, nets["slm_encoder"]


def test_encoder_keys_match_the_jax_tree():
    """k_proj has no bias; every other key and shape as ``init_whisper_encoder``."""
    tree, _, enc = tiny_encoder()
    want = {k: np.shape(v) for k, v in flatten(tree).items()}
    got = {k: tuple(v.shape) for k, v in enc.state_dict().items()}
    assert got == want
    assert "layers.0.self_attn.k_proj.bias" not in got


@pytest.mark.parametrize("t_in,t_out", [(11, 29), (40, 17), (7, 7), (1, 5), (121, 80)])
def test_interpolate_linear(t_in, t_out):
    rng = np.random.default_rng(t_in * 100 + t_out)
    x = rnd(rng, 2, 3, t_in)
    close(j_conv.interpolate_linear(jnp.asarray(x), out_len=t_out),
          t_conv.interpolate_linear(torch.from_numpy(x), t_out), atol=0, rtol=0)


@pytest.mark.parametrize("length", [4800, 4801, 57600])
def test_resample_24k_to_16k(length):
    _, width, orig, new = t_resample._sinc_kernel(24000, 16000)
    assert (width, orig, new) == (10, 3, 2)
    x = rnd(np.random.default_rng(length), 2, length, scale=0.1)
    theirs = j_resample.resample(jnp.asarray(x), 24000, 16000)
    ours = t_resample.resample(torch.from_numpy(x), 24000, 16000)
    assert ours.shape == theirs.shape == (2, -(-2 * length // 3))
    close(theirs, ours, atol=2e-6)


def test_whisper_log_mel():
    x = rnd(np.random.default_rng(1), 2, 3200, scale=0.1)
    cfg = tiny_whisper_cfg()
    np.testing.assert_array_equal(t_whisper.slaney_fbanks(), j_whisper.slaney_fbanks())
    theirs = j_whisper.whisper_log_mel(jnp.asarray(x), cfg)
    ours = t_whisper.whisper_log_mel(torch.from_numpy(x), t_whisper.WhisperConfig())
    assert ours.shape == theirs.shape == (2, 80, 21)
    close(theirs, ours, atol=2e-5, rtol=1e-5)


def test_whisper_encoder_hidden_states():
    tree, jcfg, enc = tiny_encoder()
    mel = rnd(np.random.default_rng(2), 2, 80, 22)
    theirs = j_whisper.whisper_encoder_apply(tree, jnp.asarray(mel), jcfg)
    ours = t_whisper.whisper_encoder_apply(enc, torch.from_numpy(mel))
    assert len(ours) == len(theirs) == jcfg.num_layers + 1 == 3
    for a, b in zip(theirs, ours):
        assert b.shape == a.shape == (2, 11, jcfg.d_model)
        close(a, b, atol=1e-5)


def test_slm_feature_loss_and_gradient():
    """The loss and its gradient to y_rec; the real side takes none."""
    tree, jcfg, enc = tiny_encoder()
    rng = np.random.default_rng(4)
    wav, y_rec = rnd(rng, 2, 4800, scale=0.1), rnd(rng, 2, 4800, scale=0.1)

    def j_loss(w, y):
        return j_slm.slm_feature_loss(tree, w, y, jcfg, 300)

    loss, (g_wav, g_y) = jax.value_and_grad(j_loss, argnums=(0, 1))(jnp.asarray(wav),
                                                                      jnp.asarray(y_rec))
    assert not np.asarray(g_wav).any()
    w_t = torch.from_numpy(wav).requires_grad_()
    y_t = torch.from_numpy(y_rec).requires_grad_()
    ours = t_slm.slm_feature_loss(enc, w_t, y_t, 300)
    ours.backward()
    np.testing.assert_allclose(float(ours), float(loss), rtol=1e-5)
    assert w_t.grad is None
    scale = float(np.abs(np.asarray(g_y)).max())
    err = float((y_t.grad - torch.from_numpy(np.asarray(g_y))).abs().max())
    assert err <= 1e-5 * scale, (err, scale)
