"""The port's multispeaker (LibriTTS) serving path against the JAX package:
the style-conditioned denoiser (``StyleTransformer1d``), ``compute_style``,
``synthesize`` with a reference style mixed by alpha/beta, ``style_transfer``,
the HiFi-GAN's one-frame right shift, and the port's refusal of a
multispeaker request without a reference style.

One tiny multispeaker HiFi-GAN tree (styletts2_tpu/testing.py's config) is
loaded into both packages.  Modules are held at 1e-5; the engines are fed
the same noise (the port takes the ADPM2 step noise and the harmonic
source's dither that the JAX engine draws from its keys), their durations
must be equal and the waveforms meet PARITY.md's envelope.
"""

import copy
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.infer import InferenceEngine as JaxEngine
from styletts2_tpu.models import common as j_cm
from styletts2_tpu.models import plbert as j_plbert
from styletts2_tpu.models import predictor as j_predictor
from styletts2_tpu.models import style_encoder as j_style
from styletts2_tpu.models import text_encoder as j_text_encoder
from styletts2_tpu.models.decoder import hifigan as j_hifigan
from styletts2_tpu.models.diffusion import denoiser as j_denoiser
from styletts2_tpu.nn.norm import ada_layer_norm as j_ada_layer_norm
from styletts2_tpu.testing import tiny_model_params
from styletts2_tpu.utils import materialize_params
from styletts2_tpu_torch.config import ModelParams, _build
from styletts2_tpu_torch.infer import InferenceEngine
from styletts2_tpu_torch.models.diffusion import denoiser as t_denoiser
from styletts2_tpu_torch.models.plbert import PLBertConfig
from styletts2_tpu_torch.models.zoo import STYLE_INFERENCE_NETS, build_nets, load_jax_params
from styletts2_tpu_torch.nn.norm import ada_layer_norm

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_models import PLBERT, close, parity_envelope, rnd, t_  # noqa: E402

torch.set_num_threads(1)

PHONEMES = ["ðə kwɪk bɹaʊn fɑks dʒʌmps.", "hɛloʊ wɜːld"]
STEPS = 5
WIDTH, ASR_RES = 64, 8


@functools.lru_cache(maxsize=None)
def tiny_ms():
    """(JAX params as numpy, the port's nets with them loaded, configs): the
    inference nets and both style encoders of a multispeaker HiFi-GAN zoo."""
    jmp = tiny_model_params(multispeaker=True, decoder_type="hifigan")
    jpl = j_plbert.PLBertConfig(**PLBERT)
    tr = jmp.diffusion.transformer

    def init(key):
        ks = jax.random.split(key, 8)
        return {
            "bert": j_plbert.init_plbert(ks[0], jpl),
            "bert_encoder": j_cm.init_linear(ks[1], jpl.hidden_size, jmp.hidden_dim),
            "predictor": j_predictor.init_prosody_predictor(
                ks[2], jmp.style_dim, jmp.hidden_dim, jmp.n_layer, jmp.max_dur),
            "decoder": j_hifigan.init_decoder(ks[3], jmp.decoder, jmp.hidden_dim,
                                              jmp.style_dim, width=WIDTH, asr_res_ch=ASR_RES),
            "text_encoder": j_text_encoder.init_text_encoder(
                ks[4], jmp.n_token, jmp.hidden_dim, kernel_size=5, depth=jmp.n_layer),
            "diffusion": {"transformer": j_denoiser.init_denoiser(
                ks[5], channels=jmp.style_dim * 2, context_embedding_features=jpl.hidden_size,
                num_layers=tr.num_layers, num_heads=tr.num_heads,
                head_features=tr.head_features, multiplier=tr.multiplier,
                embedding_max_length=jpl.max_position_embeddings,
                style_dim=jmp.style_dim * 2)},
            "style_encoder": j_style.init_style_encoder(ks[6], jmp.dim_in, jmp.style_dim,
                                                        jmp.hidden_dim),
            "predictor_encoder": j_style.init_style_encoder(ks[7], jmp.dim_in, jmp.style_dim,
                                                            jmp.hidden_dim),
        }

    # shapes from the JAX initialisers without compiling them, values from
    # the JAX package's seeded numpy fill; Snake alphas at their init value 1
    zoo = materialize_params(jax.eval_shape(init, jax.random.PRNGKey(0)), seed=0)
    zoo = jax.tree_util.tree_map_with_path(
        lambda path, a: np.ones_like(a) if "alpha" in jax.tree_util.keystr(path)
        else np.asarray(a), zoo)
    mp = _build(ModelParams, dataclasses.asdict(jmp))
    pl = PLBertConfig(**PLBERT)
    nets = build_nets(mp, pl, decoder_width=WIDTH, decoder_asr_res_ch=ASR_RES)
    assert tuple(nets) == STYLE_INFERENCE_NETS
    return zoo, load_jax_params(nets, zoo), jmp, jpl, mp, pl


def reference_clip(seed=0, seconds=1.5):
    """A seeded 24 kHz clip: a gliding tone under noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(24000 * seconds)) / 24000.0
    tone = 0.3 * np.sin(2 * np.pi * (140 + 40 * t) * t)
    return (tone + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def test_ada_layer_norm():
    zoo, nets, *_ = tiny_ms()
    p = zoo["diffusion"]["transformer"]["blocks"]["0"]["attention"]["norm"]
    m = nets["diffusion"]["transformer"].blocks["0"].attention.norm
    rng = np.random.default_rng(1)
    features, style = p["fc"]["weight"].shape[0] // 2, p["fc"]["weight"].shape[1]
    x, s = rnd(rng, 2, 7, features), rnd(rng, 2, style)
    close(j_ada_layer_norm(p, jnp.asarray(x), jnp.asarray(s)), ada_layer_norm(m, t_(x), t_(s)))


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_style_transformer(scale):
    """The StyleTransformer1d: features through ``to_features`` into the
    mapping and AdaLayerNorm attention norms; at scale 2 the conditional and
    fixed-embedding branches run as one doubled batch, the features doubled
    with it."""
    zoo, nets, jmp, *_ = tiny_ms()
    rng = np.random.default_rng(2)
    c = jmp.style_dim * 2
    x, time, emb = rnd(rng, 2, 1, c), rnd(rng, 2), rnd(rng, 2, 9, PLBERT["hidden_size"])
    features = rnd(rng, 2, c, scale=0.5)
    mask = np.arange(9)[None, :] < np.array([9, 5])[:, None]
    theirs = j_denoiser.denoiser_cfg_apply(
        zoo["diffusion"]["transformer"], jnp.asarray(x), jnp.asarray(time), jnp.asarray(emb),
        embedding_scale=scale, features=jnp.asarray(features),
        num_heads=jmp.diffusion.transformer.num_heads, style_conditioned=True,
        mask=jnp.asarray(mask))
    ours = t_denoiser.denoiser_cfg_apply(
        nets["diffusion"]["transformer"], t_(x), t_(time), t_(emb), embedding_scale=scale,
        mask=t_(mask), features=t_(features))
    close(theirs, ours)


def test_compute_style():
    zoo, nets, jmp, jpl, mp, pl = tiny_ms()
    wav = reference_clip()
    theirs = JaxEngine(zoo, jmp, jpl).compute_style(wav)
    ours = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu").compute_style(wav)
    assert tuple(ours.shape) == (1, 2 * jmp.style_dim)
    close(theirs, ours)


def _jax_noise(key, b, c):
    """The JAX engine's initial and per-step ADPM2 noise for ``key``
    (styletts2_tpu/infer.py:214-216, sampler.py:136)."""
    k_noise, k_samp = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, (b, 1, c)))
    step_noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_samp, i),
                                                        (b, 1, c))) for i in range(STEPS - 1)])
    return k_samp, noise, step_noise


def _jax_tokens(jeng):
    toks = [jeng.tokens_from_phonemes(p) for p in PHONEMES]
    lengths = np.array([len(t) for t in toks], np.int32)
    tokens = np.zeros((len(toks), -(-lengths.max() // 32) * 32), np.int32)
    for i, t in enumerate(toks):
        tokens[i, : len(t)] = t
    return jnp.asarray(tokens), jnp.asarray(lengths)


@pytest.mark.parametrize("alpha,beta", [(0.3, 0.7), (0.9, 0.1)])
def test_style_transfer_matches_jax(alpha, beta):
    """``style_transfer`` (``synthesize`` with ``ref_s``) of a batch of two
    from one reference style of batch 1, which serves both requests, against
    the JAX engine: equal durations and styles at 1e-5, waveforms inside
    PARITY.md's envelope."""
    zoo, nets, jmp, jpl, mp, pl = tiny_ms()
    b, c = len(PHONEMES), 2 * jmp.style_dim
    key, source_key = jax.random.PRNGKey(7), jax.random.PRNGKey(402)
    k_samp, noise, step_noise = _jax_noise(key, b, c)

    jeng = JaxEngine(zoo, jmp, jpl)
    ref_s = jeng.compute_style(reference_clip())
    theirs, j_styles = jeng.style_transfer(PHONEMES, ref_s, alpha=alpha, beta=beta, key=key,
                                           noise=noise, diffusion_steps=STEPS,
                                           source_key=source_key, return_styles=True)
    (frontend,) = jeng._frontend_cache.values()
    tokens, lengths = _jax_tokens(jeng)
    j_dur = np.asarray(frontend(jeng.zoo, tokens, lengths, k_samp, jnp.asarray(noise),
                                jnp.asarray(ref_s), jnp.zeros((b, c)), jnp.float32(0.0))[-1])

    eng = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    t_mel = eng.frame_capacity(int(lengths.max()), int(j_dur.sum(1).max()))
    dither = np.swapaxes(np.asarray(jax.random.normal(
        jax.random.fold_in(source_key, 1), (b, t_mel * 600, 9))), 1, 2)
    ours, styles, t_dur = eng.style_transfer(
        PHONEMES, torch.from_numpy(np.asarray(ref_s)), alpha=alpha, beta=beta,
        noise=torch.from_numpy(noise), step_noise=torch.from_numpy(step_noise),
        diffusion_steps=STEPS, return_styles=True, return_durations=True,
        source_noise=torch.from_numpy(dither))
    np.testing.assert_array_equal(t_dur, j_dur)
    close(j_styles, styles)
    for w_t, w_j, n in zip(ours, theirs, j_dur.sum(1)):
        assert w_t.shape == w_j.shape == (int(n) * 600,)
        parity_envelope(w_j, w_t)


def test_one_frame_right_shift():
    """The HiFi-GAN engine feeds the decoder and the F0/N predictor its
    aligned features shifted right by one frame (the first repeated), as
    Demo/Inference_LibriTTS.ipynb cell 16; the iSTFTNet engine does not."""
    _, nets, _, _, mp, pl = tiny_ms()
    eng = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    plain = InferenceEngine(eng.nets, dataclasses.replace(
        mp, decoder=dataclasses.replace(mp.decoder, type="istftnet")), pl, device="cpu")
    rng = np.random.default_rng(4)
    t_en, d = t_(rnd(rng, 2, mp.hidden_dim, 6)), t_(rnd(rng, 2, 6, mp.hidden_dim + mp.style_dim))
    s = t_(rnd(rng, 2, mp.style_dim))
    pred_dur = torch.tensor([[2, 3, 1, 2, 1, 0], [1, 1, 2, 0, 0, 0]])
    lengths = torch.tensor([5, 3])
    with torch.no_grad():
        asr, f0, n, frames = eng._decoder_inputs(t_en, d, s, pred_dur, lengths, 12)
        asr0, f00, _, frames0 = plain._decoder_inputs(t_en, d, s, pred_dur, lengths, 12)
    torch.testing.assert_close(asr[..., 1:], asr0[..., :-1], rtol=0, atol=0)
    torch.testing.assert_close(asr[..., 0], asr0[..., 0], rtol=0, atol=0)
    assert torch.equal(frames, frames0) and not torch.allclose(f0, f00)


def test_multispeaker_synthesize_needs_a_reference_style():
    """The JAX engine fails deep in the denoiser with a KeyError here; the
    port refuses with a ValueError that says what to pass (ROADMAP.md §C),
    and so does its StyleTransformer1d called without features."""
    _, nets, jmp, _, mp, pl = tiny_ms()
    eng = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    with pytest.raises(ValueError, match="ref_s"):
        eng.synthesize(PHONEMES[0], diffusion_steps=2)
    x, emb = torch.zeros(1, 1, 2 * jmp.style_dim), torch.zeros(1, 3, PLBERT["hidden_size"])
    with pytest.raises(ValueError, match="features"):
        t_denoiser.denoiser_apply(nets["diffusion"]["transformer"], x, torch.ones(1), emb)
