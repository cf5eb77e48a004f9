"""The port's serving front door (serve.py), post-processing
(audio/postprocess.py), ``warmup`` and ``trim_tail`` against the JAX package.

``BatchSynthesizer`` is held to JAX's bucketing and grouping with stand-in
engines that record the calls, and end to end on the tiny zoo of
test_torch_models.py: seven requests of mixed length over buckets (16, 32)
with ``max_batch`` 2, the noise fed in.  Each wave comes back in input
order, equals the port engine's wave for its chunk, and meets PARITY.md's
envelope against the JAX engine's wave for that chunk given that noise.
"""

import copy
import functools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from styletts2_tpu.audio import postprocess as j_post
from styletts2_tpu.infer import InferenceEngine as JaxEngine
from styletts2_tpu.serve import BatchSynthesizer as JaxBatchSynthesizer
from styletts2_tpu_torch.audio import postprocess
from styletts2_tpu_torch.infer import SAMPLES_PER_FRAME, InferenceEngine
from styletts2_tpu_torch.models.zoo import load_jax_params
from styletts2_tpu_torch.serve import BatchSynthesizer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_models import parity_envelope, tiny  # noqa: E402
from test_torch_multispeaker import tiny_ms  # noqa: E402

torch.set_num_threads(1)

STEPS = 3
BUCKETS = (16, 32)
# tokens (with the leading pad): 23, 11, 11, 27, 4, 48 (past the last
# bucket), 8 -> chunks [1, 2], [4, 6] (bucket 16), [0, 3], [5] (bucket 32)
REQUESTS = ["ðə kwɪk bɹaʊn fɑks dʒʌmps.", "hɛloʊ wɜːld", "ðɪs ɪz ə tɛst",
            "ɪn ðə jɪɹ eɪtiːn θɜːɾi tuː.", "kæt",
            "ɪn ðə jɪɹ eɪtiːn θɜːɾi tuː, ðə pɹɛs wʌz moʊst ɪmpɔːɹtənt.", "bɪɡ dɔɡz"]


@functools.lru_cache(maxsize=None)
def tiny_quiet(multispeaker: bool = False):
    """``tiny()`` (or ``tiny_ms()``) with the decoder's output conv scaled by
    0.05 in both trees, as chip_smoke.py scales its random weights: unscaled,
    the seeded weights drive the iSTFT head's exp() to waves of ~1e6 (and
    the HiFi-GAN's tanh to +-1), where no envelope says anything."""
    zoo, nets, jmp, jpl, mp, pl = tiny_ms() if multispeaker else tiny()
    zoo = copy.deepcopy(zoo)
    post = zoo["decoder"]["generator"]["conv_post"]
    post["weight_g"] = post["weight_g"] * np.float32(0.05)
    return zoo, load_jax_params(copy.deepcopy(nets), zoo), jmp, jpl, mp, pl


def test_postprocess_equals_jax():
    """Bitwise: crossfade_concat, trim_tail and spectral_gate_denoise on
    seeded numpy input."""
    rng = np.random.default_rng(0)
    chunks = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (3000, 200, 0, 5000)]
    np.testing.assert_array_equal(postprocess.crossfade_concat(chunks),
                                  j_post.crossfade_concat(chunks))
    np.testing.assert_array_equal(postprocess.crossfade_concat(chunks, fade_ms=5.0),
                                  j_post.crossfade_concat(chunks, fade_ms=5.0))
    assert postprocess.crossfade_concat([]).shape == (0,)
    wave = np.concatenate(chunks)
    for n in (0, 50, len(wave), len(wave) + 1):
        np.testing.assert_array_equal(postprocess.trim_tail(wave, n), j_post.trim_tail(wave, n))
    tone = (np.sin(np.arange(9000) * 0.05) * 0.4).astype(np.float32)
    noisy = tone + 0.02 * rng.standard_normal(9000).astype(np.float32)
    for w in (noisy, noisy[:1500]):
        np.testing.assert_array_equal(postprocess.spectral_gate_denoise(w),
                                      j_post.spectral_gate_denoise(w))


class _Recorder:
    """A stand-in engine: texts of ``n`` tokens; records each call's texts."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def tokens_from_phonemes(self, p):
        return np.zeros(len(p), np.int32)

    def synthesize(self, texts, **kw):
        self.calls.append(list(texts))
        return [np.full(3, len(t), np.float32) for t in texts]


def test_buckets_and_grouping_equal_jax():
    buckets = (32, 64, 96, 128, 192, 256)
    ours, theirs = BatchSynthesizer(_Recorder(), max_batch=3), JaxBatchSynthesizer(
        _Recorder(), max_batch=3)
    assert [ours._bucket_of(n) for n in range(1, 301)] == [
        theirs._bucket_of(n) for n in range(1, 301)]
    assert ours._bucket_of(300) == buckets[-1]
    rng = np.random.default_rng(1)
    texts = ["a" * int(n) for n in rng.integers(1, 301, 40)]
    got = ours.synthesize_many(texts, diffusion_steps=2)
    want = theirs.synthesize_many(texts, diffusion_steps=2)
    assert ours.engine.calls == theirs.engine.calls
    assert [[texts[i] for i in c] for c in ours.chunks(texts)] == ours.engine.calls
    for w, t, w_j in zip(got, texts, want):
        np.testing.assert_array_equal(w, np.full(3, len(t), np.float32))
        np.testing.assert_array_equal(w, w_j)


def _noise(key, b, c):
    """The JAX engine's initial and per-step ADPM2 noise for a batch of b."""
    k_noise, k_samp = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, (b, 1, c)))
    step = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_samp, i), (b, 1, c)))
                     for i in range(STEPS - 1)])
    return noise, step


def test_synthesize_many_matches_jax():
    """The diffusion noise and the harmonic source's dither the JAX engine
    draws for each chunk are fed in, each in its requests' rows: the dither
    keeps the source's STFT phases well conditioned (test_torch_infer.py)."""
    zoo, nets, jmp, jpl, mp, pl = tiny_quiet()
    c = 2 * mp.style_dim
    eng = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    bs = BatchSynthesizer(eng, max_batch=2, length_buckets=BUCKETS)
    chunks = bs.chunks(REQUESTS)
    assert chunks == [[1, 2], [4, 6], [0, 3], [5]]
    n = len(REQUESTS)
    noise = np.zeros((n, 1, c), np.float32)
    step_noise = np.zeros((STEPS - 1, n, 1, c), np.float32)
    dither = np.zeros((n, 9, 1200 * SAMPLES_PER_FRAME), np.float32)
    jeng = JaxEngine(zoo, jmp, jpl)
    theirs = {}
    for j, chunk in enumerate(chunks):
        key, source_key = jax.random.PRNGKey(100 + j), jax.random.PRNGKey(200 + j)
        noise[chunk], step_noise[:, chunk] = _noise(key, len(chunk), c)
        texts = [REQUESTS[i] for i in chunk]
        waves = jeng.synthesize(texts, key=key, noise=noise[chunk], diffusion_steps=STEPS,
                                source_key=source_key)
        theirs.update(zip(chunk, waves))
        # the dither JAX drew at the chunk's frame capacity (source.py fold_in 1)
        t_mel = eng.frame_capacity(max(len(eng.tokens_from_phonemes(t)) for t in texts),
                                   max(len(w) for w in waves) // SAMPLES_PER_FRAME)
        dither[chunk, :, : t_mel * SAMPLES_PER_FRAME] = np.swapaxes(np.asarray(
            jax.random.normal(jax.random.fold_in(source_key, 1),
                              (len(chunk), t_mel * SAMPLES_PER_FRAME, 9))), 1, 2)
    feed = dict(noise=torch.from_numpy(noise), step_noise=torch.from_numpy(step_noise),
                source_noise=torch.from_numpy(dither))
    waves = bs.synthesize_many(REQUESTS, diffusion_steps=STEPS, **feed)
    assert len(waves) == n
    for chunk in chunks:
        rows = torch.tensor(chunk)
        mine = eng.synthesize([REQUESTS[i] for i in chunk], diffusion_steps=STEPS,
                              noise=feed["noise"][rows], step_noise=feed["step_noise"][:, rows],
                              source_noise=feed["source_noise"][rows])
        for i, w_e in zip(chunk, mine):
            # input order, and the engine's own wave for the request's chunk
            np.testing.assert_array_equal(waves[i], w_e)
            assert len(waves[i]) == len(theirs[i]) and len(waves[i]) % SAMPLES_PER_FRAME == 0
            parity_envelope(theirs[i], waves[i])


def test_warmup_leaves_synthesize_bit_equal():
    _, nets, _, _, mp, pl = tiny()
    eng = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    before = eng.synthesize(REQUESTS[:2], diffusion_steps=2,
                            generator=torch.Generator().manual_seed(5))
    assert eng.warmup(token_caps=(32, 64), frame_caps=(100, 300), diffusion_steps=(2,),
                      batch=2) is None
    after = eng.synthesize(REQUESTS[:2], diffusion_steps=2,
                           generator=torch.Generator().manual_seed(5))
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("trim", [0, 50])
def test_trim_tail(trim):
    """``trim_tail`` drops that many samples off each wave, as the JAX
    engine's ``w[:-trim_tail]``; the waves are float32."""
    _, nets, _, _, mp, pl = tiny()
    eng = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    kw = dict(diffusion_steps=2)
    full = eng.synthesize(REQUESTS[:2], generator=torch.Generator().manual_seed(2), **kw)
    cut = eng.synthesize(REQUESTS[:2], generator=torch.Generator().manual_seed(2),
                         trim_tail=trim, **kw)
    for f, w in zip(full, cut):
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, f[:-trim] if trim else f)
        assert len(w) == len(f) - trim
    single = eng.synthesize(REQUESTS[1], generator=torch.Generator().manual_seed(2),
                            trim_tail=trim, **kw)
    assert len(single) % SAMPLES_PER_FRAME == (SAMPLES_PER_FRAME - trim) % SAMPLES_PER_FRAME
