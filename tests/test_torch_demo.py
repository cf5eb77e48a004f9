"""``python -m styletts2_tpu_torch.demo`` on the CPU: a tiny multispeaker
HiFi-GAN config written to a temporary directory, a checkpoint saved by the
port, a seeded reference clip at 22050 Hz.  The wave file it writes is the
one the root ``demo.py``'s ``write_wav`` writes for the same samples, and
the samples are the engine's ``style_transfer`` with the checkpoint's
weights, in f32 and, under ``--bf16``, with the nets in bf16.  ``--text`` needs ``phonemizer``; without ``--device`` the demo
needs CUDA."""

import importlib.util
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from styletts2_tpu_torch import demo
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.data.dataset import _read_wav, _resample_np
from styletts2_tpu_torch.infer import InferenceEngine
from styletts2_tpu_torch.models.plbert import PLBertConfig
from styletts2_tpu_torch.models.zoo import STYLE_INFERENCE_NETS, build_nets, init_random_
from styletts2_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PHONEMES = "hɛloʊ wɜːld."
TINY = {"model_params": {
    "multispeaker": True, "dim_in": 4, "hidden_dim": 32, "max_conv_dim": 32, "n_layer": 1,
    "max_dur": 10, "style_dim": 16,
    "decoder": {"type": "hifigan", "upsample_rates": [10, 5, 3, 2],
                "upsample_kernel_sizes": [20, 10, 6, 4], "upsample_initial_channel": 32},
    "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2, "head_features": 8,
                                  "multiplier": 1}}}}


def _root_write_wav():
    """The root demo.py's ``write_wav`` (the JAX demo; it imports JAX only
    inside ``main``)."""
    spec = importlib.util.spec_from_file_location("root_demo", ROOT / "demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_wav


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    cfg_path = tmp / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(TINY))
    mp = load_config(str(cfg_path)).model_params
    nets = init_random_(build_nets(mp, PLBertConfig()), seed=5)
    ckpt = save_checkpoint(str(tmp / "ms.npz"), nets)
    rng = np.random.default_rng(0)
    t = np.arange(int(22050 * 1.5)) / 22050.0
    clip = 0.3 * np.sin(2 * np.pi * 150 * t) + 0.05 * rng.standard_normal(t.size)
    wavfile.write(tmp / "speaker.wav", 22050, (clip * 32767).astype(np.int16))
    return tmp, str(cfg_path), ckpt, str(tmp / "speaker.wav")


def test_demo_writes_the_engines_style_transfer(files):
    tmp, cfg_path, ckpt, ref = files
    out = tmp / "out.wav"
    wav = demo.main(["--config", cfg_path, "--ckpt", ckpt, "--phonemes", PHONEMES,
                     "--ref_audio", ref, "--alpha", "0.4", "--beta", "0.6", "--seed", "3",
                     "--steps", "3", "--out", str(out), "--device", "cpu"])
    with wave.open(str(out), "rb") as f:
        assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 2, 24000)
        assert f.getnframes() == len(wav) > 0 and len(wav) % 600 == 0
    want = tmp / "root_writer.wav"
    _root_write_wav()(str(want), wav)
    assert out.read_bytes() == want.read_bytes()

    mp = load_config(cfg_path).model_params
    nets = build_nets(mp, PLBertConfig(), nets=STYLE_INFERENCE_NETS)
    load_checkpoint(ckpt, nets)
    eng = InferenceEngine(nets, mp, PLBertConfig(), sigma_data=mp.diffusion.dist.sigma_data,
                          device="cpu")
    clip, sr = _read_wav(ref)
    ref_s = eng.compute_style(_resample_np(clip, sr, 24000))
    expect = eng.style_transfer(PHONEMES, ref_s, alpha=0.4, beta=0.6, diffusion_steps=3,
                                generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(wav, expect)


def test_demo_text_needs_phonemizer(files):
    if importlib.util.find_spec("phonemizer") is not None:
        pytest.skip("phonemizer is installed here")
    tmp, cfg_path, ckpt, ref = files
    with pytest.raises(ImportError, match="phonemizer"):
        demo.main(["--config", cfg_path, "--ckpt", ckpt, "--text", "Hello there.",
                   "--ref_audio", ref, "--out", str(tmp / "t.wav"), "--device", "cpu"])


def test_demo_without_device_needs_cuda(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    tmp, cfg_path, ckpt, ref = files
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main(["--config", cfg_path, "--ckpt", ckpt, "--phonemes", PHONEMES,
                   "--ref_audio", ref, "--out", str(tmp / "c.wav")])


def test_demo_bf16_is_not_ported(files):
    """Named when ``--bf16`` raised; it now serves: ``--bf16 --device cpu``
    casts the nets to bf16, sets the engine's ``compute_dtype`` and writes
    the bf16 engine's float32 wave."""
    tmp, cfg_path, ckpt, ref = files
    out = tmp / "b.wav"
    wav = demo.main(["--config", cfg_path, "--ckpt", ckpt, "--phonemes", PHONEMES, "--bf16",
                     "--ref_audio", ref, "--seed", "3", "--steps", "3", "--out", str(out),
                     "--device", "cpu"])
    assert wav.dtype == np.float32 and len(wav) > 0 and len(wav) % 600 == 0
    with wave.open(str(out), "rb") as f:
        assert f.getnframes() == len(wav)

    mp = load_config(cfg_path).model_params
    nets = build_nets(mp, PLBertConfig(), nets=STYLE_INFERENCE_NETS)
    load_checkpoint(ckpt, nets)
    eng = InferenceEngine(nets.to(torch.bfloat16), mp, PLBertConfig(),
                          sigma_data=mp.diffusion.dist.sigma_data, device="cpu",
                          compute_dtype=torch.bfloat16)
    clip, sr = _read_wav(ref)
    ref_s = eng.compute_style(_resample_np(clip, sr, 24000))
    assert ref_s.dtype == torch.bfloat16
    expect = eng.style_transfer(PHONEMES, ref_s, diffusion_steps=3,
                                generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(wav, expect)


def test_demo_needs_input():
    with pytest.raises(SystemExit):
        demo.main(["--device", "cpu"])
    assert "styletts2_tpu_torch.demo" in sys.modules
