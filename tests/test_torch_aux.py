"""The port's stage-1 modules against the JAX package's, on the CPU: the mel
frontends and the STFT loss, spectral norm and the style encoder (forward
and parameter gradients), JDC, the ASR aligner, the text encoder in train
mode, ``lstm_step``, and the weight bridge of the stage-1 nets.

One tiny parameter tree (the shapes of ``styletts2_tpu.testing.tiny_zoo``,
filled with numpy without compiling the JAX initialisers, the spectral-norm
vectors converged as the JAX initialiser converges them) is loaded into
both packages.  Tolerance 1e-5 in f32 unless noted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.audio import mel as j_mel
from styletts2_tpu.losses import stft_loss as j_stft_loss
from styletts2_tpu.models import asr as j_asr
from styletts2_tpu.models import jdc as j_jdc
from styletts2_tpu.models import style_encoder as j_style
from styletts2_tpu.models import text_encoder as j_text_encoder
from styletts2_tpu.models.decoder import istftnet as j_istftnet
from styletts2_tpu.nn.lstm import lstm_step as j_lstm_step
from styletts2_tpu.nn.param_norm import spectral_norm_kernel as j_sn_kernel
from styletts2_tpu.testing import tiny_model_params
from styletts2_tpu.utils import materialize_params
from styletts2_tpu_torch.audio import mel as t_mel
from styletts2_tpu_torch.config import DecoderConfig, ModelParams
from styletts2_tpu_torch.losses import stft_loss as t_stft_loss
from styletts2_tpu_torch.models import asr as t_asr
from styletts2_tpu_torch.models import jdc as t_jdc
from styletts2_tpu_torch.models import style_encoder as t_style
from styletts2_tpu_torch.models import text_encoder as t_text_encoder
from styletts2_tpu_torch.models.common import SNConv2d
from styletts2_tpu_torch.models.zoo import (STAGE1_NETS, build_nets, export_params, flatten,
                                            init_random_, load_jax_params)
from styletts2_tpu_torch.nn.lstm import lstm_step
from styletts2_tpu_torch.nn.param_norm import spectral_norm_kernel

torch.set_num_threads(1)

# the tiny zoo's aligner and pitch extractor (styletts2_tpu/testing.py)
J_ASR = j_asr.ASRConfig(hidden_dim=32, n_layers=1, n_token=179, token_embedding_dim=16,
                        location_kernel_size=7)
J_JDC = j_jdc.JDCConfig(lstm_hidden=8, lstm_layers=1)


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(theirs, ours, atol=1e-5, rtol=1e-5):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=rtol)


def _converge_sn(tree):
    """The JAX initialiser's 15-step power iteration on every spectral-norm
    leaf set (``init_sn_conv``), in numpy."""
    if isinstance(tree, dict):
        if "weight_orig" in tree:
            w = tree["weight_orig"].reshape(tree["weight_orig"].shape[0], -1).astype(np.float64)
            u = tree["weight_u"] / np.linalg.norm(tree["weight_u"])
            for _ in range(15):
                v = w.T @ u
                v /= max(np.linalg.norm(v), 1e-12)
                u = w @ v
                u /= max(np.linalg.norm(u), 1e-12)
            return {**tree, "weight_u": u.astype(np.float32), "weight_v": v.astype(np.float32)}
        return {k: _converge_sn(v) for k, v in tree.items()}
    return tree


@functools.lru_cache(maxsize=None)
def stage1_tiny():
    """(JAX stage-1 tree as numpy, the port's nets with it loaded, JAX
    ModelParams, port ModelParams, port ASRConfig, port JDCConfig)."""
    jmp = tiny_model_params()

    def init(key):
        ks = jax.random.split(key, 5)
        return {
            "text_encoder": j_text_encoder.init_text_encoder(
                ks[0], jmp.n_token, jmp.hidden_dim, kernel_size=5, depth=jmp.n_layer),
            "style_encoder": j_style.init_style_encoder(ks[1], jmp.dim_in, jmp.style_dim,
                                                        jmp.hidden_dim),
            "decoder": j_istftnet.init_decoder(ks[2], jmp.decoder, jmp.hidden_dim,
                                               jmp.style_dim, width=64, asr_res_ch=8),
            "text_aligner": j_asr.init_asr(ks[3], J_ASR),
            "pitch_extractor": j_jdc.init_jdc(ks[4], J_JDC),
        }

    zoo = materialize_params(jax.eval_shape(init, jax.random.PRNGKey(0)), seed=0)
    zoo = jax.tree_util.tree_map_with_path(
        lambda path, a: np.ones_like(a) if "alpha" in jax.tree_util.keystr(path)
        else np.asarray(a), zoo)
    zoo = _converge_sn(zoo)
    mp = ModelParams(dim_in=4, hidden_dim=32, max_conv_dim=32, n_layer=1, n_token=179,
                     max_dur=10, style_dim=16, decoder=DecoderConfig(upsample_initial_channel=32))
    asr = t_asr.ASRConfig(hidden_dim=32, n_layers=1, n_token=179, token_embedding_dim=16,
                          location_kernel_size=7)
    jdc = t_jdc.JDCConfig(lstm_hidden=8, lstm_layers=1)
    nets = load_jax_params(build_nets(mp, decoder_width=64, decoder_asr_res_ch=8,
                                      nets=STAGE1_NETS, asr_cfg=asr, jdc_cfg=jdc), zoo)
    return zoo, nets, jmp, mp, asr, jdc


def test_stage1_weights_round_trip():
    zoo, nets, *_ = stage1_tiny()
    back, want = flatten(export_params(nets)), flatten(zoo)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_init_random_converges_spectral_norm():
    """Random power-iteration vectors are replaced by converged ones: the
    effective kernel then has a spectral norm near 1 (15 steps, as the JAX
    initialiser takes) and the forward stays bounded."""
    mp = ModelParams(dim_in=4, hidden_dim=32, max_conv_dim=32, n_layer=1, n_token=179,
                     style_dim=16)
    nets = init_random_(build_nets(mp, nets=("style_encoder",)), seed=3)
    for m in nets.modules():
        if isinstance(m, SNConv2d):
            w = m.weight_orig.reshape(m.weight_orig.shape[0], -1).double()
            w_eff = m.weight().reshape(w.shape).double()
            assert abs(float(torch.linalg.matrix_norm(w_eff, ord=2)) - 1.0) < 0.1
    mel = torch.from_numpy(rnd(np.random.default_rng(0), 2, 1, 80, 96))
    with torch.no_grad():
        s = t_style.style_encoder_apply(nets["style_encoder"], mel)
    assert torch.isfinite(s).all() and float(s.abs().max()) < 10.0


@pytest.mark.parametrize("cfg", ["dataset", "loss"])
def test_log_mel_and_log_norm(cfg):
    rng = np.random.default_rng(0)
    wav = rnd(rng, 2, 7200, scale=0.1)
    j_cfg = j_mel.DATASET_MEL if cfg == "dataset" else j_mel.LOSS_MEL_24K
    t_cfg = t_mel.DATASET_MEL if cfg == "dataset" else t_mel.LOSS_MEL_24K
    theirs = j_mel.log_mel_spectrogram(jnp.asarray(wav), j_cfg)
    ours = t_mel.log_mel_spectrogram(t_(wav), t_cfg)
    close(theirs, ours, atol=2e-5)
    close(j_mel.melscale_fbanks(1025, 0.0, 8000.0, 80, 16000),
          t_mel.melscale_fbanks(1025, 0.0, 8000.0, 80, 16000), atol=0)
    x = rnd(rng, 2, 80, 30)
    close(j_mel.log_norm(jnp.asarray(x)), t_mel.log_norm(t_(x)))


def test_multi_resolution_stft_loss_and_gradient():
    rng = np.random.default_rng(1)
    x, y = rnd(rng, 2, 6000, scale=0.1), rnd(rng, 2, 6000, scale=0.1)
    val, grad = jax.jit(jax.value_and_grad(j_stft_loss.multi_resolution_stft_loss))(
        jnp.asarray(x), jnp.asarray(y))
    xt = t_(x).requires_grad_()
    ours = t_stft_loss.multi_resolution_stft_loss(xt, t_(y))
    ours.backward()
    close(val, ours, rtol=1e-5)
    g = np.asarray(grad)
    np.testing.assert_allclose(xt.grad.numpy(), g, atol=1e-4 * np.abs(g).max())


def test_spectral_norm_kernel_and_gradient():
    """One power iteration from stored (u, v): the refined vectors carry the
    gradient to ``weight_orig`` in both packages."""
    rng = np.random.default_rng(2)
    w, u, v = rnd(rng, 6, 3, 3, 3), rnd(rng, 6), rnd(rng, 27)
    g = rnd(rng, 6, 3, 3, 3)

    def j_loss(w_):
        k, _ = j_sn_kernel({"weight_orig": w_, "weight_u": jnp.asarray(u),
                            "weight_v": jnp.asarray(v)}, n_power_iterations=1)
        return jnp.sum(k * g), k

    (_, j_k), j_g = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(w))
    wt = t_(w).requires_grad_()
    t_k, _, _ = spectral_norm_kernel(wt, t_(u), t_(v), n_power_iterations=1)
    (t_k * t_(g)).sum().backward()
    close(j_k, t_k)
    close(j_g, wt.grad, atol=1e-5)


def test_style_encoder_forward_and_parameter_gradients():
    zoo, nets, *_ = stage1_tiny()
    rng = np.random.default_rng(3)
    mel = rnd(rng, 2, 1, 80, 83)
    cot = rnd(rng, 2, 16)
    lengths = np.array([83, 81], np.int32)

    def j_loss(p):
        s = j_style.style_encoder_apply(p, jnp.asarray(mel))
        return jnp.sum(s * cot), s

    (_, j_s), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(zoo["style_encoder"])
    m = nets["style_encoder"]
    m.zero_grad()
    t_s = t_style.style_encoder_apply(m, t_(mel))
    (t_s * t_(cot)).sum().backward()
    close(j_s, t_s)
    grads = {k: p.grad for k, p in m.named_parameters()}
    for k, g in flatten(j_g).items():
        if k in grads:                            # the (u, v) buffers take no gradient
            g = np.asarray(g)
            np.testing.assert_allclose(grads[k].numpy(), g, atol=1e-4 * np.abs(g).max() + 1e-7,
                                       err_msg=k)
        else:
            assert k.endswith(("weight_u", "weight_v")) and not np.asarray(g).any(), k
    with torch.no_grad():
        close(j_style.style_encoder_apply(zoo["style_encoder"], jnp.asarray(mel),
                                          jnp.asarray(lengths)),
              t_style.style_encoder_apply(m, t_(mel), t_(lengths)))


def test_jdc():
    zoo, nets, *_ = stage1_tiny()
    mel = rnd(np.random.default_rng(4), 2, 1, 80, 24)
    theirs = j_jdc.jdc_apply(zoo["pitch_extractor"], jnp.asarray(mel), J_JDC)
    with torch.no_grad():
        ours = t_jdc.jdc_apply(nets["pitch_extractor"], t_(mel))
    for a, b in zip(theirs, ours):
        close(a, b, atol=2e-5)


def _asr_inputs(seed):
    rng = np.random.default_rng(seed)
    b, t_mel, t_text = 2, 40, 9
    mels = rnd(rng, b, 80, t_mel)
    texts = rng.integers(4, 179, (b, t_text)).astype(np.int32)
    mel_len = np.array([40, 28])
    mem_mask = np.arange(t_mel // 2)[None, :] + 1 > (mel_len // 2)[:, None]
    return mels, texts, mem_mask


def test_asr_aligner_eval():
    zoo, nets, *_ = stage1_tiny()
    mels, texts, mem_mask = _asr_inputs(5)
    theirs = j_asr.asr_apply(zoo["text_aligner"], jnp.asarray(mels), jnp.asarray(mem_mask),
                             jnp.asarray(texts), J_ASR)
    with torch.no_grad():
        ours = t_asr.asr_apply(nets["text_aligner"], t_(mels), t_(mem_mask), t_(texts).long())
    for k in ("ctc_logits", "s2s_logits", "s2s_attn", "duration_predictions"):
        close(theirs[k], ours[k], atol=2e-5)


def test_asr_aligner_train_masks_from_jax():
    """Train mode fed the masks the JAX aligner draws from its key: conv
    dropout ``fold_in(fold_in(rng, 100+i), 2j | 2j+1)``, token masking
    ``fold_in(rng, 7)``, decoder dropout ``split(fold_in(rng, 8), T+1)``."""
    zoo, nets, *_ = stage1_tiny()
    mels, texts, mem_mask = _asr_inputs(6)
    rng = jax.random.PRNGKey(11)
    b, t_text = texts.shape
    length, h = mels.shape[-1] // 2, J_ASR.hidden_dim
    conv_keep = np.stack([np.stack([np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(jax.random.fold_in(rng, 100 + i), 2 * j + k), 0.8, (b, h, length)))
        for k in range(2)]) for j in range(3)]) for i in range(J_ASR.n_layers)])
    unk = np.asarray(jax.random.uniform(jax.random.fold_in(rng, 7), (b, t_text))
                     < J_ASR.random_mask)
    keys = jax.random.split(jax.random.fold_in(rng, 8), t_text + 1)
    hid_keep = np.stack([np.asarray(jax.random.bernoulli(keys[s], 0.5, (b, h // 2)))
                         for s in range(t_text + 1)])
    theirs = j_asr.asr_apply(zoo["text_aligner"], jnp.asarray(mels), jnp.asarray(mem_mask),
                             jnp.asarray(texts), J_ASR, train=True, rng=rng)
    noise = t_asr.ASRNoise(conv_keep=t_(conv_keep), hidden_keep=t_(hid_keep), token_unk=t_(unk))
    with torch.no_grad():
        ours = t_asr.asr_apply(nets["text_aligner"], t_(mels), t_(mem_mask), t_(texts).long(),
                               noise)
    for k in ("ctc_logits", "s2s_logits", "s2s_attn"):
        close(theirs[k], ours[k], atol=2e-5)


def test_asr_config_refuses_unported_options():
    with pytest.raises(NotImplementedError, match="stochastic_depth_rate"):
        t_asr.ASRConfig(stochastic_depth_rate=0.1)
    with pytest.raises(NotImplementedError, match="intermediate_ctc_layers"):
        t_asr.ASRConfig(intermediate_ctc_layers=(2,))


def test_text_encoder_train_mode_masks_from_jax():
    """Dropout 0.2 after each CNN block, fed the masks JAX draws with
    ``bernoulli(fold_in(rng, i), 0.8, shape)``; the gradient of a cotangent
    as well."""
    zoo, nets, jmp, *_ = stage1_tiny()
    rng = np.random.default_rng(7)
    b, t = 2, 11
    tokens = rng.integers(1, 179, (b, t)).astype(np.int32)
    lengths = np.array([11, 6], np.int32)
    cot = rnd(rng, b, jmp.hidden_dim, t)
    key = jax.random.PRNGKey(3)
    keep = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), 0.8,
                                                     (b, jmp.hidden_dim, t)))
                     for i in range(jmp.n_layer)])

    def j_loss(p):
        y = j_text_encoder.text_encoder_apply(p, jnp.asarray(tokens), jnp.asarray(lengths),
                                              train=True, rng=key)
        return jnp.sum(y * cot), y

    (_, j_y), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(zoo["text_encoder"])
    m = nets["text_encoder"]
    m.zero_grad()
    t_y = t_text_encoder.text_encoder_apply(m, t_(tokens).long(), t_(lengths), t_(keep))
    (t_y * t_(cot)).sum().backward()
    close(j_y, t_y)
    grads = dict(m.named_parameters())
    for k, g in flatten(j_g).items():
        g = np.asarray(g)
        np.testing.assert_allclose(grads[k].grad.numpy(), g, atol=1e-4 * np.abs(g).max() + 1e-7,
                                   err_msg=k)


def test_lstm_step():
    rng = np.random.default_rng(8)
    cell = torch.nn.LSTMCell(6, 5)
    x, h, c = rnd(rng, 3, 6), rnd(rng, 3, 5), rnd(rng, 3, 5)
    p = {k: v.detach().numpy() for k, v in cell.state_dict().items()}
    j_h, j_c = j_lstm_step(p, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    with torch.no_grad():
        t_h, t_c = lstm_step(cell, t_(x), t_(h), t_(c))
        ref_h, ref_c = cell(t_(x), (t_(h), t_(c)))
    close(j_h, t_h)
    close(j_c, t_c)
    close(ref_h, t_h)
    close(ref_c, t_c)
