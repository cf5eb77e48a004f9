"""The port's LJSpeech inference slice as a whole, against the JAX engine.

Both engines run the tiny zoo of test_torch_models.py (one parameter tree)
on the same phonemes and noise: the port is fed the ADPM2 step noise and the
harmonic-source dither the JAX engine draws from its keys.  Durations must be
equal and the waveforms meet PARITY.md's envelope.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.audio.mel import log_mel_spectrogram
from styletts2_tpu.infer import InferenceEngine as JaxEngine
from styletts2_tpu_torch.infer import InferenceEngine
from styletts2_tpu_torch.models.zoo import build_nets, export_params, flatten, load_jax_params

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_models import parity_envelope, tiny  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PHONEMES = ["ðə kwɪk bɹaʊn fɑks dʒʌmps.", "hɛloʊ wɜːld"]
STEPS = 5


def test_engine_matches_jax():
    zoo, nets, jmp, jpl, mp, pl = tiny()
    b, c = len(PHONEMES), 2 * jmp.style_dim
    key, source_key = jax.random.PRNGKey(7), jax.random.PRNGKey(402)
    # the JAX engine splits its key: initial noise, then fold_in(k_samp, i)
    # for ADPM2 step i (styletts2_tpu/infer.py:214-216, sampler.py:136)
    k_noise, k_samp = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, (b, 1, c)))
    step_noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_samp, i),
                                                        (b, 1, c))) for i in range(STEPS - 1)])

    jeng = JaxEngine(zoo, jmp, jpl)
    theirs = jeng.synthesize(PHONEMES, key=key, noise=noise, diffusion_steps=STEPS,
                             source_key=source_key)
    (frontend,) = jeng._frontend_cache.values()
    tokens, lengths = _jax_tokens(jeng)
    j_dur = np.asarray(frontend(jeng.zoo, tokens, lengths, k_samp, jnp.asarray(noise),
                                jnp.zeros((b, c)), jnp.zeros((b, c)), jnp.float32(0.0))[-1])

    eng = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    t_mel = eng.frame_capacity(int(lengths.max()), int(j_dur.sum(1).max()))
    # the source dither the JAX engine drew at that capacity (source.py fold_in 1)
    dither = np.swapaxes(np.asarray(jax.random.normal(
        jax.random.fold_in(source_key, 1), (b, t_mel * 600, 9))), 1, 2)
    ours, t_dur = eng.synthesize(PHONEMES, noise=torch.from_numpy(noise),
                                 step_noise=torch.from_numpy(step_noise),
                                 diffusion_steps=STEPS, return_durations=True,
                                 source_noise=torch.from_numpy(dither))
    np.testing.assert_array_equal(t_dur, j_dur)
    for w_t, w_j in zip(ours, theirs):
        assert w_t.shape == w_j.shape
        parity_envelope(w_j, w_t)
        mel_l1 = np.abs(np.asarray(log_mel_spectrogram(jnp.asarray(w_t[None])))
                        - np.asarray(log_mel_spectrogram(jnp.asarray(w_j[None])))).mean()
        assert mel_l1 < 1e-2, mel_l1


def _jax_tokens(jeng):
    toks = [jeng.tokens_from_phonemes(p) for p in PHONEMES]
    lengths = np.array([len(t) for t in toks], np.int32)
    tokens = np.zeros((len(toks), -(-lengths.max() // 32) * 32), np.int32)
    for i, t in enumerate(toks):
        tokens[i, : len(t)] = t
    return jnp.asarray(tokens), jnp.asarray(lengths)


def test_long_form_carries_the_style_over():
    _, nets, _, _, mp, pl = tiny()
    eng = InferenceEngine(copy.deepcopy(nets), mp, pl, device="cpu")
    sentences = ["ðə kwɪk bɹaʊn fɑks.", "hɛloʊ."]
    got = eng.long_form(sentences, t=0.7, generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    w0, s0 = eng.synthesize(sentences[0], generator=gen, return_styles=True)
    w1 = eng.synthesize(sentences[1], generator=gen, s_prev=s0, prev_blend=0.7)
    np.testing.assert_array_equal(got, np.concatenate([w0, w1]))


def test_load_jax_params_round_trip():
    zoo, nets, _, _, mp, pl = tiny()
    back = flatten(export_params(nets))
    want = flatten(zoo)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].shape == np.shape(v), k
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    fresh = load_jax_params(build_nets(mp, pl, decoder_width=64, decoder_asr_res_ch=8), zoo)
    for (ka, a), (kb, b) in zip(fresh.state_dict().items(), nets.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_engine_leaves_the_callers_position_table():
    """The engine grows its own copy of PL-BERT's position table: the
    caller's nets keep theirs (64 rows here), their weights still load
    strictly into a fresh zoo, and the engine synthesises past row 64."""
    zoo, nets, _, _, mp, pl = tiny()
    rows = nets["bert"].embeddings["position_embeddings"].weight.shape[0]
    eng = InferenceEngine(nets, mp, pl, device="cpu")
    assert nets["bert"].embeddings["position_embeddings"].weight.shape[0] == rows == 64
    assert tuple(eng.bert_positions.shape) == (1024, pl.embedding_size)
    torch.testing.assert_close(eng.bert_positions[:rows],
                               nets["bert"].embeddings["position_embeddings"].weight)
    assert torch.equal(eng.bert_positions[rows:],
                       eng.bert_positions[rows - 1].expand(1024 - rows, -1))
    fresh = load_jax_params(build_nets(mp, pl, decoder_width=64, decoder_asr_res_ch=8),
                            export_params(nets))
    for (ka, a), (kb, b) in zip(fresh.state_dict().items(), nets.state_dict().items()):
        assert ka == kb and torch.equal(a, b)
    long_text = " ".join(PHONEMES * 3)
    tokens, _ = eng.tokenize([long_text])
    assert tokens.shape[1] > rows
    wav = eng.synthesize(long_text, diffusion_steps=2, generator=torch.Generator().manual_seed(0))
    assert wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()


def test_port_imports_no_jax():
    """Every module of the port imports without jax and without the JAX
    package (in a fresh interpreter: this one has imported jax already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import styletts2_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) > 20, names\n"
        "need = {'audio.mel', 'losses.stft_loss', 'models.style_encoder', 'models.jdc',\n"
        "        'models.asr', 'ops.monotonic', 'kernels.maximum_path', 'kernels.adain_snake',\n"
        "        'train.optimizers', 'train.stage1', 'train.loop', 'nn.conv',\n"
        "        'audio.resample', 'models.whisper', 'models.discriminators', 'losses.gan',\n"
        "        'losses.slm', 'native', 'data.dataset', 'utils', 'nn.init',\n"
        "        'train.torch_compat', 'train.checkpoint', 'train.validate', 'train_stage1',\n"
        "        'ops.alignment', 'losses.slmadv', 'train.stage2', 'train.samples',\n"
        "        'train_stage2', 'models.decoder.hifigan', 'text.phonemize', 'demo',\n"
        "        'serve', 'audio.postprocess'}\n"
        "missing = {n for n in need if pkg.__name__ + '.' + n not in names}\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'styletts2_tpu' or m.startswith('styletts2_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    chip = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in chip and "styletts2_tpu." not in chip.replace(
        "styletts2_tpu_torch", "")


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, nets, _, _, mp, pl = tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(nets, mp, pl)
