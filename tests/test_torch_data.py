"""The port's data pipeline (``data/dataset.py``), native binding
(``native.py``) and metrics log (``utils.py``) against the JAX package's,
on files the tests write: WAVs at 22050 and 24000 Hz, a FLAC
(``flac_tools.py``) and an unreadable file.  Batches must be equal exactly:
both packages run the same host code on the same bytes.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile as sw
import torch

from styletts2_tpu import native as j_native
from styletts2_tpu.data import dataset as j_dataset
from styletts2_tpu_torch import native as t_native
from styletts2_tpu_torch.data import dataset as t_dataset

sys.path.insert(0, str(Path(__file__).parent))
from flac_tools import encode_flac  # noqa: E402

torch.set_num_threads(1)

PHONEMES = ["ðɪ ɛkstɹə pɹɛʃɚ wʌz sʌdn̩.", "hiː sɛd ðæt ðə ɹɪpɔːɹt wʌz ɹɛdi.",
            "ɪn ðə jɪɹ eɪtiːn θɜːɾi tuː.", "ðə kʌmɪʃən ɹɪvjuːd ðə ɛvɪdəns."]


def _pcm(rng, n):
    return (rng.standard_normal(n) * 0.1 * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eleven clips of 0.4-0.9 s over three speakers: WAVs at 22050 and
    24000 Hz, one FLAC at 24000 Hz, and an unreadable ``.wav``; an OOD list."""
    root = tmp_path_factory.mktemp("torch_corpus")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(10):
        sr = 22050 if i % 2 else 24000
        n = int(sr * (0.4 + 0.05 * i))
        if i == 4:
            name = f"u{i}.flac"
            (root / name).write_bytes(encode_flac(_pcm(rng, n), sr, subframe="fixed2"))
        else:
            name = f"u{i}.wav"
            sw.write(root / name, sr, _pcm(rng, n))
        lines.append(f"{name}|{PHONEMES[i % 4]}|{i % 3}\n")
    (root / "broken.wav").write_bytes(b"RIFF\x00\x00not a wave file")
    lines.insert(3, f"broken.wav|{PHONEMES[0]}|1\n")
    ood = root / "ood.txt"
    ood.write_text("\n".join(f"aʊt əv dɪstɹɪbjuːʃən sɛntəns nʌmbɚ {i}|0" for i in range(4)))
    return str(root), lines, str(ood)


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("validation", [False, True])
def test_batches_equal_jax(corpus, num_workers, validation):
    """Every array of every batch over two epochs, shuffled (train) or in
    order with the last short batch (validation), serial and threaded; the
    unreadable file is skipped as in JAX."""
    root, lines, ood = corpus
    kw = dict(validation=validation, OOD_data=ood, min_length=5, batch_size=3, seed=3,
              num_workers=num_workers, prefetch_batches=1)
    ours = t_dataset.build_dataloader(lines, root, **kw)
    theirs = j_dataset.build_dataloader(lines, root, num_shards=1, shard_index=0, **kw)
    assert ours.local_batch_size == theirs.local_batch_size == 3
    for epoch in (0, 1):
        got, want = list(ours(epoch)), list(theirs(epoch))
        assert len(got) == (4 if validation else 3)
        _assert_batches_equal(got, want)


def test_shards_follow_torch_distributed(corpus, monkeypatch):
    """With a process group of two, rank 1 takes the JAX package's shard 1."""
    import torch.distributed as dist

    root, lines, ood = corpus
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    kw = dict(OOD_data=ood, min_length=5, batch_size=4, seed=1)
    ours = t_dataset.build_dataloader(lines, root, **kw)
    theirs = j_dataset.build_dataloader(lines, root, num_shards=2, shard_index=1, **kw)
    assert ours.local_batch_size == 2
    _assert_batches_equal(list(ours(0)), list(theirs(0)))


def test_read_audio_and_skip(corpus):
    """Each format decodes as in JAX (the 22050 Hz clips resample to 24 kHz
    the same way); the unreadable file raises the port's own error."""
    root, lines, _ = corpus
    for line in lines:
        name = line.split("|")[0]
        if name == "broken.wav":
            with pytest.raises(t_dataset.UnreadableAudioError):
                t_dataset._read_audio(f"{root}/{name}")
            continue
        wave, sr = t_dataset._read_audio(f"{root}/{name}")
        want, want_sr = j_dataset._read_audio(f"{root}/{name}")
        assert sr == want_sr
        np.testing.assert_array_equal(wave, want)
        np.testing.assert_array_equal(t_dataset._resample_np(wave, sr, 24000),
                                      j_dataset._resample_np(want, sr, 24000))
    ds = t_dataset.FilePathDataset(lines, root)
    assert ds[3].path == lines[4].split("|")[0]          # skipped to the next file


def test_native_host_functions():
    """The port's binding gives the JAX binding's DP paths and resampling."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((3, 11, 17)).astype(np.float32)
    tx, ty = np.array([11, 6, 9], np.int32), np.array([17, 12, 9], np.int32)
    np.testing.assert_array_equal(t_native.maximum_path_host(vals, tx, ty),
                                  j_native.maximum_path_host(vals, tx, ty))
    wave = rng.standard_normal(22050).astype(np.float32)
    got = t_native.resample_host(wave, 22050, 24000)
    assert len(got) == 24000
    np.testing.assert_array_equal(got, j_native.resample_host(wave, 22050, 24000))
    assert t_native.available() == j_native.available()


def test_metrics_writer(tmp_path):
    from styletts2_tpu.utils import MetricsWriter as JWriter
    from styletts2_tpu_torch.utils import MetricsWriter

    for cls, sub in ((MetricsWriter, "ours"), (JWriter, "theirs")):
        w = cls(str(tmp_path / sub))
        w.add_scalars(3, {"mel_loss": np.float32(0.5), "g_loss": 2})
        w.add_scalars(4, {"mel_loss": 0.25}, prefix="val")
        w.close()
    ours = (tmp_path / "ours" / "metrics.jsonl").read_text()
    assert ours == (tmp_path / "theirs" / "metrics.jsonl").read_text()
    assert json.loads(ours.splitlines()[1]) == {"step": 4, "val/mel_loss": 0.25}
