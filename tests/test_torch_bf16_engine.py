"""The port's bf16 engine (bf16 nets, ``compute_dtype=torch.bfloat16``)
against the JAX engine, LJSpeech (iSTFTNet) and LibriTTS (multispeaker,
HiFi-GAN), on the quieted tiny zoos of test_torch_serve.py.

bf16 rounds at other places in the two packages, so the port's bf16 waves
are held against the JAX f32 waves no farther than 1.5x the JAX bf16
engine's own distance from them, plus 1e-3, over the call's batch: the max
|difference| past each wave's first 700 samples (PARITY.md's head, the STFT
frame-0 branch cut) and the mean log-mel L1.  Both
run the same noise, and the durations are pinned: each synthesis takes the
JAX f32 frontend's ``pred_dur``, since a bf16 duration that crosses .5
rounds to another frame count.  The frontend's pre-rounding duration sums
are held to JAX bf16's at 2e-2.
"""

import copy
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.audio.mel import DATASET_MEL, log_mel_spectrogram
from styletts2_tpu.infer import InferenceEngine as JaxEngine
from styletts2_tpu.models.style_encoder import style_encoder_apply
from styletts2_tpu.nn.linear import linear as j_linear
from styletts2_tpu.nn.lstm import bilstm as j_bilstm
from styletts2_tpu.utils import cast_pytree
from styletts2_tpu_torch.infer import SAMPLES_PER_FRAME, InferenceEngine
from styletts2_tpu_torch.models.predictor import duration_logits

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_multispeaker import reference_clip  # noqa: E402
from test_torch_serve import tiny_quiet  # noqa: E402

torch.set_num_threads(1)

PHONEMES = ["ðə kwɪk bɹaʊn fɑks dʒʌmps.", "hɛloʊ wɜːld"]
STEPS = 3
HEAD = 700


def _tokens(eng):
    toks = [eng.tokens_from_phonemes(p) for p in PHONEMES]
    lengths = np.array([len(t) for t in toks], np.int32)
    tokens = np.zeros((len(toks), 32), np.int32)
    for i, t in enumerate(toks):
        tokens[i, : len(t)] = t
    return jnp.asarray(tokens), jnp.asarray(lengths)


def _jax_durations(zoo, d, lengths):
    """The JAX frontend's pre-rounding durations from its ``d``."""
    x = j_bilstm(zoo["predictor"]["lstm"], d, lengths)
    proj = zoo["predictor"]["duration_proj"]["linear_layer"]
    logits = j_linear(x, proj["weight"], proj["bias"])
    return np.asarray(jax.nn.sigmoid(logits).sum(-1), np.float32)


@jax.jit
def _jax_style(zoo, wave):
    """``JaxEngine.compute_style``, jitted (eager, it dispatches hundreds of
    one-op programs here)."""
    mel = log_mel_spectrogram(wave[None], DATASET_MEL)[:, None]
    return jnp.concatenate([style_encoder_apply(zoo["style_encoder"], mel),
                            style_encoder_apply(zoo["predictor_encoder"], mel)], axis=-1)


@functools.lru_cache(maxsize=None)
def run(model: str):
    """The JAX f32 and bf16 engines and the port's bf16 engine on the same
    noise, each synthesis at the JAX f32 durations."""
    zoo, nets, jmp, jpl, mp, pl = tiny_quiet(model == "libritts")
    b, c = len(PHONEMES), 2 * jmp.style_dim
    k_noise, k_samp = jax.random.split(jax.random.PRNGKey(7))
    noise = np.asarray(jax.random.normal(k_noise, (b, 1, c)))
    step_noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_samp, i),
                                                        (b, 1, c))) for i in range(STEPS - 1)])
    zj = jax.tree_util.tree_map(jnp.asarray, zoo)
    j32 = JaxEngine(zj, jmp, jpl)
    j16 = JaxEngine(cast_pytree(zj, jnp.bfloat16), jmp, jpl, compute_dtype=jnp.bfloat16)
    tokens, lengths = _tokens(j32)
    use_ref = mp.multispeaker

    ref32, ref16 = ((np.asarray(_jax_style(e.zoo, reference_clip()), np.float32)
                     if use_ref else np.zeros((1, c), np.float32)) for e in (j32, j16))

    def frontend(eng, ref):
        eng._alpha, eng._beta = 0.3, 0.7
        fn = eng._frontend_fn(tokens.shape[1], STEPS, 1.0, use_ref)
        return fn(eng.zoo, tokens, lengths, k_samp, jnp.asarray(noise),
                  jnp.broadcast_to(jnp.asarray(ref), (b, c)), jnp.zeros((b, c)),
                  jnp.float32(0.0))

    f32, f16 = frontend(j32, ref32), frontend(j16, ref16)
    pred_dur = np.asarray(f32[-1])
    port = InferenceEngine(copy.deepcopy(nets).to(torch.bfloat16), mp, pl, device="cpu",
                           compute_dtype=torch.bfloat16)
    t_mel = port.frame_capacity(int(np.asarray(lengths).max()), int(pred_dur.sum(1).max()))

    def synth(eng, f):
        wav = eng._synth_fn(tokens.shape[1], t_mel)(eng.zoo, *f[:4], jnp.asarray(pred_dur),
                                                     lengths)
        return np.asarray(wav.astype(jnp.float32))

    with torch.inference_mode():
        tk, ln = port.tokenize(PHONEMES)
        ln = torch.from_numpy(ln)
        ref_s = port.compute_style(reference_clip()) if use_ref else None
        out = port._frontend(tk, ln, torch.from_numpy(noise), torch.from_numpy(step_noise),
                             STEPS, 1.0, None, 0.0,
                             None if ref_s is None else ref_s.float().expand(b, -1))
        ours = port._synthesis(*out[:4], torch.from_numpy(pred_dur), ln, t_mel)
        durations = torch.sigmoid(duration_logits(port.nets["predictor"], out[1], ln)).sum(-1)
        served = port.synthesize(PHONEMES, noise=torch.from_numpy(noise),
                                 step_noise=torch.from_numpy(step_noise),
                                 diffusion_steps=STEPS, ref_s=ref_s, return_durations=True)
    return dict(
        frames=pred_dur.sum(1), j32=synth(j32, f32), j16=synth(j16, f16),
        ours=ours, dur_j16=_jax_durations(j16.zoo, f16[1], lengths), dur_ours=durations,
        lengths=np.asarray(lengths), ref_s=ref_s, served=served, ref16=ref16)


def _mel(w):
    return np.asarray(log_mel_spectrogram(jnp.asarray(w[None])))


@pytest.mark.parametrize("model", ["ljspeech", "libritts"])
def test_bf16_engine_near_jax_f32(model):
    r = run(model)
    # the iSTFT head computes in f32; the HiFi-GAN's tanh gives the compute dtype
    assert r["ours"].dtype == (torch.bfloat16 if model == "libritts" else torch.float32)
    dist = {"ours": [], "jax": []}
    mel = {"ours": [], "jax": []}
    for i, frames in enumerate(r["frames"]):
        n = int(frames) * SAMPLES_PER_FRAME
        want = r["j32"][i, :n]
        for name, w in (("ours", r["ours"][i, :n].float().numpy()), ("jax", r["j16"][i, :n])):
            assert np.isfinite(w).all()
            dist[name].append(np.abs(w - want)[HEAD:].max())
            mel[name].append(np.abs(_mel(w) - _mel(want)).mean())
    assert max(dist["ours"]) <= 1.5 * max(dist["jax"]) + 1e-3, dist
    assert np.mean(mel["ours"]) <= 1.5 * np.mean(mel["jax"]) + 1e-3, mel


@pytest.mark.parametrize("model", ["ljspeech", "libritts"])
def test_bf16_frontend_durations_near_jax_bf16(model):
    """Pre-rounding duration sums at 2e-2 over the valid tokens; the served
    waves are float32 of ``sum(pred_dur) * 600`` samples; a multispeaker
    model's ``compute_style`` gives a bf16 style near JAX bf16's (within 2
    bf16 ulps of its largest entry)."""
    r = run(model)
    for i, n in enumerate(r["lengths"]):
        np.testing.assert_allclose(r["dur_ours"][i, :n].float().numpy(), r["dur_j16"][i, :n],
                                   atol=2e-2, rtol=0)
    waves, durs = r["served"]
    for w, dur in zip(waves, durs):
        assert w.dtype == np.float32 and np.isfinite(w).all()
        assert len(w) == int(dur.sum()) * SAMPLES_PER_FRAME
    if model == "libritts":
        assert r["ref_s"].dtype == torch.bfloat16
        ref16 = r["ref16"]
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref16).max())) - 7)
        np.testing.assert_allclose(r["ref_s"].float().numpy(), ref16, atol=2 * ulp, rtol=0)
