"""The trainers' sample dumps, and stage 1 of multispeaker and HiFi-GAN configs.

Stage 1 dumps samples after each validation, as the JAX loop does
(``styletts2_tpu/train/loop.py:248-256``): ``train_stage1`` builds the
frozen nets the dump reads (``STAGE1_SAMPLE_NETS``), never steps them and
saves them for stage 2.  A dump that raises logs a warning and the run
carries on, in both stages.  Both trainers and the entry points take a
multispeaker or HiFi-GAN config.
"""

import logging
import math
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile as sw
import torch
import yaml

from styletts2_tpu_torch import train_stage1
from styletts2_tpu_torch.config import Config, load_config
from styletts2_tpu_torch.models.zoo import (STAGE1_NETS, STAGE1_SAMPLE_NETS, build_nets,
                                            init_reference_)
from styletts2_tpu_torch.train import samples
from styletts2_tpu_torch.train.stage1 import Stage1Trainer
from styletts2_tpu_torch.train.stage2 import Stage2Trainer

torch.set_num_threads(1)


def _corpus(root: Path, n: int, prefix: str, rng) -> None:
    lines = []
    for i in range(n):
        wave = (0.1 * rng.standard_normal(int(24000 * (0.7 + 0.05 * i))) * 32767)
        sw.write(root / f"{prefix}{i}.wav", 24000, wave.astype(np.int16))
        lines.append(f"{prefix}{i}.wav|ðə kʌmɪʃən ɹɪvjuːd ðə ɛvɪdəns {i}.|0\n")
    (root / f"{prefix}_list.txt").write_text("".join(lines))


@pytest.fixture
def tiny_yml(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    _corpus(tmp_path, 4, "train", rng)
    _corpus(tmp_path, 2, "val", rng)
    spec = {"log_dir": str(tmp_path / "logs"), "first_stage_path": "first_stage.npz",
            "epochs_1st": 1, "save_freq": 1, "log_interval": 1, "batch_size": 2,
            "max_len": 80,
            "data_params": {"train_data": str(tmp_path / "train_list.txt"),
                            "val_data": str(tmp_path / "val_list.txt"),
                            "root_path": str(tmp_path), "OOD_data": "", "num_workers": 0},
            "model_params": {"dim_in": 4, "hidden_dim": 32, "max_conv_dim": 32, "n_layer": 1,
                             "max_dur": 10, "style_dim": 16,
                             "decoder": {"upsample_initial_channel": 32}},
            "loss_params": {"TMA_epoch": 5}}
    yml = tmp_path / "tiny.yml"
    yml.write_text(yaml.safe_dump(spec))
    monkeypatch.setenv("STYLETTS2_ALLOW_RANDOM_ENCODERS", "1")
    return yml, tmp_path / "logs"


def test_stage1_run_dumps_samples(tiny_yml):
    """One stage-1 epoch from files: validation, then the dump's three wave
    files and the alignment per sample; the frozen nets the dump reads are
    never stepped and are saved in the stage-1 checkpoint."""
    yml, logs = tiny_yml
    state = train_stage1.main(["--config_path", str(yml), "--device", "cpu"])
    assert (state.epoch, state.iters) == (1, 2)
    out = logs / "samples" / "epoch_00000"
    for i in range(2):
        for name in (f"{i}_gt.wav", f"{i}_rec.wav", f"{i}_pred.wav"):
            sr, wav = sw.read(out / name)
            assert sr == 24000 and wav.dtype == np.int16 and wav.size > 0, name
        assert (out / f"{i}_attn.png").exists() or (out / f"{i}_attn.npy").exists()

    mp = train_stage1.grow_n_token(load_config(str(yml))).model_params
    fresh = init_reference_(build_nets(mp, nets=STAGE1_NETS + STAGE1_SAMPLE_NETS),
                            torch.Generator().manual_seed(train_stage1.INIT_SEED))
    for name in STAGE1_SAMPLE_NETS:
        for (k, a), (_, b) in zip(state.nets[name].state_dict().items(),
                                  fresh[name].state_dict().items()):
            assert torch.equal(a.cpu(), b), f"{name}.{k} moved"
    with np.load(logs / "first_stage.npz") as data:
        for name in STAGE1_SAMPLE_NETS:
            assert any(k.startswith(f"net.{name}.") for k in data.files), name
            assert not any(k.startswith(f"adamw.{name}.") for k in data.files), name


def test_a_failing_dump_warns_and_the_run_goes_on(tiny_yml, monkeypatch, caplog):
    yml, logs = tiny_yml

    def broken(*args, **kw):
        raise RuntimeError("made to fail")

    monkeypatch.setattr(samples, "generate_samples", broken)
    with caplog.at_level(logging.WARNING, logger="styletts2_tpu_torch.train.loop"):
        state = train_stage1.main(["--config_path", str(yml), "--device", "cpu"])
    assert (state.epoch, state.iters) == (1, 2)
    warned = [r for r in caplog.records if "sample generation failed" in r.getMessage()]
    assert len(warned) == 1 and "made to fail" in warned[0].getMessage()
    assert (logs / "first_stage.npz").exists()
    assert all(math.isfinite(p.float().sum()) for p in state.nets.parameters())


HIFIGAN = {"type": "hifigan", "upsample_rates": [10, 5, 3, 2],
           "upsample_kernel_sizes": [20, 10, 6, 4], "upsample_initial_channel": 32}


@pytest.mark.parametrize("overrides", [{"multispeaker": True}, {"decoder": HIFIGAN}])
def test_trainers_refuse_multispeaker_and_hifigan(overrides, tiny_yml):
    """Formerly the refusal of a multispeaker or HiFi-GAN config; both
    trainers now take such a config, and ``train_stage1`` trains an epoch
    of it from files: validation, the sample dump and ``first_stage.npz``
    (the style from a second clip for the multispeaker model, the HiFi-GAN
    decoder in its training form)."""
    yml, logs = tiny_yml
    spec = yaml.safe_load(yml.read_text())
    spec["model_params"].update(overrides)
    yml.write_text(yaml.safe_dump(spec))
    cfg = load_config(str(yml))
    configs = {"model": cfg.model_params}
    Stage1Trainer(Config(), configs, torch.nn.ModuleDict(), None)
    Stage2Trainer(Config(), configs, torch.nn.ModuleDict(), None)
    state = train_stage1.main(["--config_path", str(yml), "--device", "cpu"])
    assert (state.epoch, state.iters) == (1, 2)
    assert state.nets["decoder"].generator.cfg.type == cfg.model_params.decoder.type
    assert (logs / "first_stage.npz").is_file()
    assert len(list((logs / "samples" / "epoch_00000").glob("*.wav"))) == 6
    assert all(math.isfinite(p.float().sum()) for p in state.nets.parameters())
