"""Multispeaker HiFi-GAN training on the CPU at the tiny size: the fine-tune
recipe through ``run_stage2(finetune=True)`` with its ``ft`` checkpoints and
a resume equal to the uninterrupted run, ``train_stage1`` then
``train_stage2`` from files on a tiny four-speaker corpus, and a strict
``load_jax_params`` round trip of the JAX package's whole LibriTTS training
zoo.  The real HiFi-GAN decoder runs here (its parity with the JAX decoder
is ``test_torch_hifigan_train.py``'s).
"""

import copy
import dataclasses
import functools
import math
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.io.wavfile as sw
import torch
import yaml

from styletts2_tpu.models.asr import ASRConfig as JASRConfig
from styletts2_tpu.models.jdc import JDCConfig as JJDCConfig
from styletts2_tpu.models.plbert import PLBertConfig as JPLBertConfig
from styletts2_tpu.models.zoo import build_zoo
from styletts2_tpu.testing import tiny_model_params, tiny_whisper_cfg
from styletts2_tpu.utils import materialize_params
from styletts2_tpu_torch import train_stage1, train_stage2
from styletts2_tpu_torch.config import Config, ModelParams, SlmAdvParams, _build
from styletts2_tpu_torch.models.asr import ASRConfig
from styletts2_tpu_torch.models.decoder import hifigan
from styletts2_tpu_torch.models.jdc import JDCConfig
from styletts2_tpu_torch.models.plbert import PLBertConfig
from styletts2_tpu_torch.models.whisper import WhisperConfig
from styletts2_tpu_torch.models.zoo import (STAGE2_NETS, build_nets, export_params, flatten,
                                            init_reference_, load_jax_params)
from styletts2_tpu_torch.train.checkpoint import load_checkpoint
from styletts2_tpu_torch.train.loop import run_stage2
from styletts2_tpu_torch.train.stage2 import generator_nets

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_gan import MPD_CH, MSD_W  # noqa: E402
from test_torch_models import PLBERT  # noqa: E402
from test_torch_stage2_ms import ms_batch  # noqa: E402

torch.set_num_threads(1)

ASR = dict(hidden_dim=32, n_layers=1, n_token=179, token_embedding_dim=16,
           location_kernel_size=7)
JDC = dict(lstm_hidden=8, lstm_layers=1)
WIDTH, ASR_RES = 64, 8
ADV = SlmAdvParams(min_len=40, max_len=60, iter=2)
# the tiny multispeaker HiFi-GAN config of styletts2_tpu/testing.py as YAML
# model_params (the slm keys stay Whisper-base's: the entry points build it)
TINY_YML = {"multispeaker": True, "dim_in": 4, "hidden_dim": 32, "max_conv_dim": 32,
            "n_layer": 1, "max_dur": 10, "style_dim": 16,
            "decoder": {"type": "hifigan", "upsample_rates": [10, 5, 3, 2],
                        "upsample_kernel_sizes": [20, 10, 6, 4],
                        "upsample_initial_channel": 32},
            "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2, "head_features": 8,
                                          "multiplier": 1}}}


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """The runs write ~GB of checkpoints (the entry points' full-size
    Whisper-base and MPD among them): removed once a test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def ms_nets():
    """(port ModelParams, the 14 ``STAGE2_NETS`` of the tiny multispeaker
    HiFi-GAN config with the reference's initialisation, seed 0)."""
    mp = _build(ModelParams, dataclasses.asdict(tiny_model_params(True, "hifigan")))
    nets = build_nets(mp, PLBertConfig(**PLBERT), decoder_width=WIDTH,
                      decoder_asr_res_ch=ASR_RES, nets=STAGE2_NETS, asr_cfg=ASRConfig(**ASR),
                      jdc_cfg=JDCConfig(**JDC),
                      whisper_cfg=WhisperConfig(**tiny_whisper_cfg().__dict__),
                      mpd_channels=MPD_CH, msd_width=MSD_W)
    assert isinstance(nets["decoder"], hifigan.Decoder)
    return mp, init_reference_(nets, torch.Generator().manual_seed(0))


def states(nets):
    return {n: [t.clone() for t in net.state_dict().values()] for n, net in nets.items()}


def test_run_stage2_finetune_resume_equals_an_uninterrupted_run(tmp_path):
    """Two fine-tune epochs (every net from step 0: the alignment trained,
    ``mono_loss`` and ``s2s_loss``, a generator-SLM then a WD step; a
    validation and a sample dump after each) straight through, against a
    run resumed from the ``epoch_ft_00000.npz`` that the straight run wrote
    after epoch 0: the same parameters and ``sigma_data`` to 1e-6 and the
    same logged losses for epoch 1; the checkpoints carry the ``ft`` tag;
    the text encoder and the aligner move, the pitch extractor and the
    Whisper encoder do not."""
    mp, base = ms_nets()

    def run(log_dir, epochs, resume_from=None):
        nets = copy.deepcopy(base)
        if resume_from:
            init_reference_(nets, torch.Generator().manual_seed(3))    # overwritten at load
        cfg = Config(log_interval=1, max_len=80, epochs=epochs, save_freq=1, model_params=mp,
                     slmadv_params=ADV, log_dir=str(log_dir))
        logs = []
        state = run_stage2(cfg, {"model": mp, "whisper": nets["slm_encoder"].cfg}, nets,
                           lambda e: iter([ms_batch(e), ms_batch(e + 5)]),
                           lambda e: iter([ms_batch(9)]),
                           log_cb=lambda it, m: logs.append((it, m)), resume_from=resume_from,
                           device="cpu", seed=0, finetune=True)
        return state, logs

    straight, logs = run(tmp_path / "a", 2)
    resumed, resumed_logs = run(tmp_path / "b", 2, str(tmp_path / "a" / "epoch_ft_00000.npz"))
    assert (straight.epoch, straight.iters) == (resumed.epoch, resumed.iters) == (2, 4)
    assert [it for it, _ in logs] == [1, 2, 2, 3, 4, 4]
    assert logs[3:] == resumed_logs
    steps = [m for _, m in logs if "val_mel_loss" not in m]
    assert all({"mono_loss", "s2s_loss", "gen_loss_slm" if i % 2 == 0 else "d_loss_slm"}
               <= set(m) for i, m in enumerate(steps))
    assert all(math.isfinite(v) for _, m in logs for v in m.values())
    assert all(m["d_loss"] > 0 and m["diff_loss"] > 0 for m in steps)
    np.testing.assert_allclose(resumed.sigma_data, straight.sigma_data, rtol=0, atol=1e-6)
    assert straight.sigma_data != mp.diffusion.dist.sigma_data
    for name in STAGE2_NETS:
        for (k, a), b in zip(straight.nets[name].state_dict().items(),
                             resumed.nets[name].state_dict().values()):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{name}.{k}")
    before = states(base)
    after = states(straight.nets)
    moved = {n for n in before if any(not torch.equal(a, b)
                                      for a, b in zip(before[n], after[n]))}
    assert moved == set(generator_nets(True, True, True)) | {"mpd", "msd", "wd"}
    assert {"text_encoder", "text_aligner"} <= moved
    for tag in ("a", "b"):
        for name in ("epoch_ft_00001.npz", "ft_stage.npz"):
            _, epoch, iters, extra = load_checkpoint(str(tmp_path / tag / name))
            assert (epoch, iters) == (2, 4)
            np.testing.assert_allclose(extra["sigma_data"], straight.sigma_data, atol=1e-6)
        assert not list((tmp_path / tag).glob("*2nd*"))
    for tag, epochs in (("a", (0, 1)), ("b", (1,))):
        for epoch in epochs:
            assert len(list((tmp_path / tag / "samples" / f"epoch_{epoch:05d}").glob(
                "*.wav"))) == 6


def _corpus(root: Path, n: int, prefix: str, rng, speakers: int = 4) -> str:
    """``n`` seeded noise WAVs at 24 kHz dealt round ``speakers`` speakers,
    and their ``wav|phonemes|speaker`` list."""
    lines = []
    for i in range(n):
        wave = 0.1 * rng.standard_normal(int(24000 * (0.7 + 0.05 * i))) * 32767
        sw.write(root / f"{prefix}{i}.wav", 24000, wave.astype(np.int16))
        lines.append(f"{prefix}{i}.wav|ðə kʌmɪʃən ɹɪvjuːd ðə ɛvɪdəns {i}.|{i % speakers}\n")
    path = root / f"{prefix}_list.txt"
    path.write_text("".join(lines))
    return str(path)


def libritts_yml(tmp_path, **top):
    """A tiny multispeaker HiFi-GAN config over a four-speaker corpus."""
    rng = np.random.default_rng(0)
    (tmp_path / "ood.txt").write_text("".join(
        f"ðə kʌmɪʃən ɹɪvjuːd ðə ɛvɪdəns ɪn dɪteɪl, ænd faʊnd ðæt ðə wɪtnəsᵻz əɡɹiːd {i}.|0\n"
        for i in range(3)))
    spec = {"log_dir": str(tmp_path / "logs"), "first_stage_path": "first_stage.npz",
            "epochs_1st": 1, "epochs_2nd": 1, "save_freq": 1, "log_interval": 1,
            "batch_size": 2, "max_len": 80,
            "data_params": {"train_data": _corpus(tmp_path, 4, "train", rng),
                            "val_data": _corpus(tmp_path, 2, "val", rng),
                            "root_path": str(tmp_path), "OOD_data": str(tmp_path / "ood.txt"),
                            "min_length": 20, "num_workers": 0},
            "model_params": TINY_YML,
            "loss_params": {"TMA_epoch": 5, "diff_epoch": 0, "joint_epoch": 0},
            "slmadv_params": {"min_len": 40, "max_len": 60, "iter": 2}, **top}
    yml = tmp_path / "libritts_tiny.yml"
    yml.write_text(yaml.safe_dump(spec, allow_unicode=True))
    return yml


def test_train_stage1_then_stage2_entry_points_on_libritts(tmp_path, monkeypatch):
    """``python -m styletts2_tpu_torch.train_stage1`` then ``train_stage2``
    (``--device cpu``) on a tiny multispeaker HiFi-GAN config over four
    speakers: stage 1 trains an epoch, validates, dumps samples and writes
    ``first_stage.npz``; stage 2 starts from it and trains a joint epoch
    with the reference styles (a generator-SLM and a WD step), validates,
    dumps samples and writes ``2nd_stage.npz`` with ``sigma_data``."""
    monkeypatch.setenv("STYLETTS2_ALLOW_RANDOM_ENCODERS", "1")
    yml = libritts_yml(tmp_path)
    logs_dir = tmp_path / "logs"
    s1 = train_stage1.main(["--config_path", str(yml), "--device", "cpu"])
    assert (s1.epoch, s1.iters) == (1, 2)
    assert isinstance(s1.nets["decoder"], hifigan.Decoder)
    assert (logs_dir / "first_stage.npz").is_file()
    logs = []
    s2 = train_stage2.main(["--config_path", str(yml), "--device", "cpu"],
                           log_cb=lambda it, m: logs.append((it, m)))
    assert (s2.epoch, s2.iters) == (1, 2)
    assert [it for it, _ in logs] == [1, 2, 2]
    assert "gen_loss_slm" in logs[0][1] and "d_loss_slm" in logs[1][1]
    assert all(math.isfinite(v) for _, m in logs for v in m.values())
    assert logs[0][1]["diff_loss"] > 0
    _, epoch, iters, extra = load_checkpoint(str(logs_dir / "2nd_stage.npz"))
    assert (epoch, iters) == (1, 2) and math.isfinite(extra["sigma_data"])
    for stage_dir in ("epoch_00000",):
        assert len(list((logs_dir / "samples" / stage_dir).glob("*.wav"))) == 6


def test_load_jax_params_round_trip_of_a_libritts_training_zoo():
    """The JAX package's whole multispeaker HiFi-GAN training zoo
    (``build_zoo``: every one of the 14 ``STAGE2_NETS``, the aligner, MPD,
    MSD, the Whisper discriminator and encoder included) loads into
    ``build_nets``' nets with ``strict=True`` and exports back unchanged."""
    jmp = tiny_model_params(multispeaker=True, decoder_type="hifigan")
    zoo = materialize_params(jax.eval_shape(lambda k: build_zoo(
        k, jmp, JPLBertConfig(**PLBERT), JASRConfig(**ASR), JJDCConfig(**JDC),
        tiny_whisper_cfg(), include_slm=True, decoder_width=WIDTH,
        decoder_asr_res_ch=ASR_RES), jax.random.PRNGKey(0)), seed=1)
    assert sorted(zoo) == sorted(STAGE2_NETS)
    mp = _build(ModelParams, dataclasses.asdict(jmp))
    nets = load_jax_params(build_nets(
        mp, PLBertConfig(**PLBERT), decoder_width=WIDTH, decoder_asr_res_ch=ASR_RES,
        nets=STAGE2_NETS, asr_cfg=ASRConfig(**ASR), jdc_cfg=JDCConfig(**JDC),
        whisper_cfg=WhisperConfig(**tiny_whisper_cfg().__dict__)), zoo)
    assert isinstance(nets["decoder"], hifigan.Decoder)
    assert hasattr(nets["diffusion"]["transformer"], "to_features")
    back, want = flatten(export_params(nets)), flatten(zoo)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
