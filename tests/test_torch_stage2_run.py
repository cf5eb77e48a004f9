"""The port's stage-2 trainer on the CPU at the tiny size: ``run_stage2``
across ``diff_epoch`` and ``joint_epoch`` with a WD step, a resume equal to
the uninterrupted run, and the ``train_stage2`` entry point from a
``first_stage.npz`` that ``train_stage1`` wrote (and its ``--finetune`` from
such a file, and its CUDA default).  The real decoder runs here.
"""

import copy
import dataclasses
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from styletts2_tpu_torch.config import Config, SlmAdvParams
from styletts2_tpu_torch.models.zoo import STAGE2_NETS, flatten, init_reference_
from styletts2_tpu_torch.train.checkpoint import load_checkpoint
from styletts2_tpu_torch.train.loop import host_draws, run_stage2
from styletts2_tpu_torch.train.stage2 import PROSODY, SLM_GENERATOR

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_checkpoint import _write_corpus  # noqa: E402
from test_torch_stage2 import stage2_batch  # noqa: E402
from test_torch_stage2_parts import stage2_tiny  # noqa: E402

torch.set_num_threads(1)

LP = Config().loss_params
ADV = SlmAdvParams(min_len=40, max_len=60, iter=2)
BASE_METRICS = {"mel_loss", "dur_loss", "ce_loss", "norm_loss", "F0_loss", "lm_loss",
                "sty_loss", "diff_loss", "gen_loss", "g_loss", "d_loss"}


def tiny_run(epochs, diff_epoch, joint_epoch, log_dir=""):
    """(Config, configs, fresh copy of the tiny 14 nets); no checkpoints
    without ``log_dir``."""
    _, nets, _, _, _, mp = stage2_tiny()
    cfg = Config(log_interval=1, max_len=80, epochs_2nd=epochs, save_freq=1, model_params=mp,
                 slmadv_params=ADV, log_dir=log_dir,
                 loss_params=dataclasses.replace(LP, diff_epoch=diff_epoch,
                                                 joint_epoch=joint_epoch))
    return cfg, {"model": mp, "whisper": nets["slm_encoder"].cfg}, copy.deepcopy(nets)


def states(nets):
    return {n: [t.clone() for t in net.state_dict().values()] for n, net in nets.items()}


def moved(before, after):
    return {n for n in before if any(not torch.equal(a, b) for a, b in zip(before[n], after[n]))}


def test_run_stage2_across_phases_on_cpu():
    """Two steps in each phase: before diffusion, with diffusion and the
    MPD/MSD, joint (a generator SLM step, then a WD step): finite losses,
    the metrics of each phase, and per step the nets that move (the
    others bitwise equal); ``sigma_data`` estimated from the diffusion on."""
    cfg, configs, nets = tiny_run(3, 1, 2)
    snaps, logs = [states(nets)], []

    def log_cb(it, metrics):
        logs.append(metrics)
        snaps.append(states(nets))

    state = run_stage2(cfg, configs, nets, lambda e: iter([stage2_batch(e), stage2_batch(e + 3)]),
                       log_cb=log_cb, device="cpu", seed=0)
    assert (state.epoch, state.iters, len(logs)) == (3, 6, 6)
    assert all(math.isfinite(v) for m in logs for v in m.values())
    for m in logs[:4]:
        assert set(m) == BASE_METRICS
    assert set(logs[4]) == BASE_METRICS | {"gen_loss_slm", "slm_valid_fraction"}
    assert set(logs[5]) == BASE_METRICS | {"d_loss_slm", "slm_valid_fraction"}
    assert all(m["d_loss"] == 0.0 and m["diff_loss"] == 0.0 for m in logs[:2])
    assert all(m["d_loss"] > 0 and m["diff_loss"] > 0 for m in logs[2:])
    assert logs[4]["slm_valid_fraction"] > 0 and logs[5]["slm_valid_fraction"] > 0
    want = [set(PROSODY)] * 2 + [set(PROSODY) | {"diffusion", "mpd", "msd"}] * 2 + [
        set(PROSODY) | {"diffusion", "mpd", "msd", "style_encoder", "decoder"},
        set(PROSODY) | {"diffusion", "mpd", "msd", "style_encoder", "decoder", "wd"}]
    for i, w in enumerate(want):
        assert moved(snaps[i], snaps[i + 1]) == w, i
    assert set(SLM_GENERATOR) < want[4]
    assert math.isfinite(state.sigma_data) and state.sigma_data != 0.2
    # the host draws: the WD step on every second batch of a joint epoch
    assert [host_draws(0, it, i, True, 2)[1] for it, i in ((4, 0), (5, 1))] == [False, True]
    assert host_draws(0, 5, 1, False, 2)[1:] == (False, False, False, False)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Two epochs (the first with diffusion, the second joint with a WD
    step; validation and a sample dump after each) straight through,
    against the same run stopped after epoch 0 and resumed from
    ``epoch_2nd_00000.npz``: the same parameters and ``sigma_data`` to
    1e-6, and the same logged losses."""
    def run(log_dir, epochs, resume_from=None):
        cfg, configs, nets = tiny_run(epochs, 0, 1, log_dir=str(log_dir))
        if resume_from:
            init_reference_(nets, torch.Generator().manual_seed(3))    # overwritten at load
        logs = []
        state = run_stage2(cfg, configs, nets,
                           lambda e: iter([stage2_batch(e), stage2_batch(e + 5)]),
                           lambda e: iter([stage2_batch(9)]),
                           log_cb=lambda it, m: logs.append((it, m)), resume_from=resume_from,
                           device="cpu", seed=0)
        return state, logs

    straight, logs = run(tmp_path / "a", 2)
    first, first_logs = run(tmp_path / "b", 1)
    assert (first.epoch, first.iters) == (1, 2)
    resumed, resumed_logs = run(tmp_path / "b", 2, str(tmp_path / "b" / "epoch_2nd_00000.npz"))
    assert (straight.epoch, straight.iters) == (resumed.epoch, resumed.iters) == (2, 4)
    assert [it for it, _ in logs] == [1, 2, 2, 3, 4, 4]
    assert logs == first_logs + resumed_logs
    assert set(logs[2][1]) == {"val_mel_loss", "val_dur_loss", "val_F0_loss"}
    assert "d_loss_slm" in logs[4][1]
    np.testing.assert_allclose(resumed.sigma_data, straight.sigma_data, rtol=0, atol=1e-6)
    for name in STAGE2_NETS:
        for (k, a), b in zip(straight.nets[name].state_dict().items(),
                             resumed.nets[name].state_dict().values()):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{name}.{k}")
    for tag in ("a", "b"):
        for name in ("epoch_2nd_00001.npz", "2nd_stage.npz"):
            _, epoch, iters, extra = load_checkpoint(str(tmp_path / tag / name))
            assert (epoch, iters) == (2, 4)
            np.testing.assert_allclose(extra["sigma_data"], straight.sigma_data, atol=1e-6)
        for epoch in (0, 1):
            out = tmp_path / tag / "samples" / f"epoch_{epoch:05d}"
            assert sorted(os.listdir(out)) == sorted(
                f"{i}_{k}" for i in (0, 1) for k in ("gt.wav", "rec.wav", "pred.wav",
                                                     "attn.npy" if _no_matplotlib()
                                                     else "attn.png"))


def _no_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return True
    return False


def test_train_stage2_entry_point_from_stage1_on_cpu(tmp_path, monkeypatch):
    """``python -m styletts2_tpu_torch.train_stage2 --device cpu`` on a
    shrunk config: it starts from the ``first_stage.npz`` that
    ``train_stage1.main`` wrote (the stage-1 nets equal the file's), trains
    one joint epoch with an OOD text list (a generator SLM step and a WD
    step), validates, dumps samples and writes ``epoch_2nd_00000.npz`` and
    ``2nd_stage.npz`` with ``sigma_data``."""
    import yaml

    from styletts2_tpu_torch import train_stage1, train_stage2

    rng = np.random.default_rng(0)
    _write_corpus(tmp_path, 4, rng, "train")
    _write_corpus(tmp_path, 2, rng, "val")
    (tmp_path / "ood.txt").write_text("".join(
        f"ðə kʌmɪʃən ɹɪvjuːd ðə ɛvɪdəns ɪn dɪteɪl, ænd faʊnd ðæt ðə wɪtnəsᵻz əɡɹiːd {i}.|0\n" for i in range(3)))
    spec = {"log_dir": str(tmp_path / "logs"), "first_stage_path": "first_stage.npz",
            "epochs_1st": 1, "epochs_2nd": 1, "save_freq": 1, "log_interval": 1,
            "batch_size": 2, "max_len": 80,
            "data_params": {"train_data": str(tmp_path / "train_list.txt"),
                            "val_data": str(tmp_path / "val_list.txt"),
                            "root_path": str(tmp_path), "OOD_data": str(tmp_path / "ood.txt"),
                            "min_length": 20, "num_workers": 2},
            "model_params": {"dim_in": 4, "hidden_dim": 32, "max_conv_dim": 32, "n_layer": 1,
                             "max_dur": 10, "style_dim": 16,
                             "decoder": {"upsample_initial_channel": 32},
                             "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2,
                                                           "head_features": 8,
                                                           "multiplier": 1}}},
            "loss_params": {"TMA_epoch": 5, "diff_epoch": 0, "joint_epoch": 0},
            "slmadv_params": {"min_len": 40, "max_len": 60, "iter": 2}}
    yml = tmp_path / "tiny.yml"
    yml.write_text(yaml.safe_dump(spec, allow_unicode=True))
    monkeypatch.setenv("STYLETTS2_ALLOW_RANDOM_ENCODERS", "1")
    train_stage1.main(["--config_path", str(yml), "--device", "cpu"])
    first_stage = tmp_path / "logs" / "first_stage.npz"
    assert first_stage.is_file()

    logs = []
    state = train_stage2.main(["--config_path", str(yml), "--device", "cpu"],
                              log_cb=lambda it, m: logs.append((it, m)))
    assert (state.epoch, state.iters) == (1, 2)
    assert [it for it, _ in logs] == [1, 2, 2]
    assert "gen_loss_slm" in logs[0][1] and "d_loss_slm" in logs[1][1]
    assert set(logs[2][1]) == {"val_mel_loss", "val_dur_loss", "val_F0_loss"}
    assert all(math.isfinite(v) for _, m in logs for v in m.values())
    params, *_ = load_checkpoint(str(first_stage))
    # stage 1's nets and the frozen ones its sample dumps read
    assert sorted(params) == sorted(("text_encoder", "style_encoder", "decoder",
                                     "text_aligner", "pitch_extractor", "bert",
                                     "bert_encoder", "predictor", "predictor_encoder"))
    for name in ("text_aligner", "pitch_extractor", "text_encoder"):     # never trained
        for k, v in state.nets[name].state_dict().items():
            want = params[name]
            for part in k.split("."):
                want = want[part]
            np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{name}.{k}")
    for name in ("epoch_2nd_00000.npz", "2nd_stage.npz"):
        _, epoch, iters, extra = load_checkpoint(str(tmp_path / "logs" / name))
        assert (epoch, iters) == (1, 2) and math.isfinite(extra["sigma_data"])
    assert len(os.listdir(tmp_path / "logs" / "samples" / "epoch_00000")) == 8
    assert train_stage1.find_resume_checkpoint(spec["log_dir"], "2nd").endswith(
        "epoch_2nd_00000.npz")


def test_train_stage2_refuses_finetune_and_needs_cuda(tmp_path, monkeypatch):
    """Formerly the refusal of ``--finetune``: without a device the entry
    point still needs CUDA, and ``--finetune --device cpu`` now runs the
    fine-tune recipe on a tiny multispeaker HiFi-GAN config over four
    speakers, from a ``pretrained_model`` ``.npz`` holding the model's
    nets (seeded apart from the entry point's own initialisation): one
    epoch with every net trained, the aligner's losses, validation, samples
    and the ``ft`` checkpoints."""
    from styletts2_tpu_torch import train_stage1, train_stage2
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.models.zoo import build_nets
    from styletts2_tpu_torch.train.checkpoint import save_checkpoint
    from styletts2_tpu_torch.train.stage2 import generator_nets
    from test_torch_libritts_run import libritts_yml

    if not torch.cuda.is_available():
        for extra in ([], ["--finetune"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                train_stage2.main(["--config_path", str(tmp_path / "absent.yml")] + extra)
    monkeypatch.setenv("STYLETTS2_ALLOW_RANDOM_ENCODERS", "1")
    ft_logs = tmp_path / "logs_ft"
    pretrained = tmp_path / "pretrained.npz"
    ft_yml = libritts_yml(tmp_path, epochs=1, log_dir=str(ft_logs),
                          pretrained_model=str(pretrained))
    mp = train_stage1.grow_n_token(load_config(str(ft_yml))).model_params
    nets = build_nets(mp, nets=generator_nets(True, True, True))
    save_checkpoint(str(pretrained), init_reference_(nets, torch.Generator().manual_seed(1)))
    logs = []
    state = train_stage2.main(["--config_path", str(ft_yml), "--device", "cpu", "--finetune"],
                              log_cb=lambda it, m: logs.append((it, m)))
    assert (state.epoch, state.iters) == (1, 2)
    assert [it for it, _ in logs] == [1, 2, 2]
    assert all({"mono_loss", "s2s_loss", "diff_loss"} <= set(m) for _, m in logs[:2])
    assert "gen_loss_slm" in logs[0][1] and "d_loss_slm" in logs[1][1]
    assert all(math.isfinite(v) for _, m in logs for v in m.values())
    params, *_ = load_checkpoint(str(pretrained))
    for name in ("text_encoder", "text_aligner"):        # trained in the fine-tune recipe
        want = flatten(params[name])
        assert any(not np.array_equal(v.numpy(), want[k])
                   for k, v in state.nets[name].state_dict().items()), name
    for name in ("epoch_ft_00000.npz", "ft_stage.npz"):
        _, epoch, iters, extra = load_checkpoint(str(ft_logs / name))
        assert (epoch, iters) == (1, 2) and math.isfinite(extra["sigma_data"])
    assert train_stage1.find_resume_checkpoint(str(ft_logs), "ft").endswith(
        "epoch_ft_00000.npz")
