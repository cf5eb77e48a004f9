"""The port's checkpoints (``train/checkpoint.py``, ``train/torch_compat.py``)
against the JAX package's file layout and conversions, the resume of
``run_stage1``, and the stage-1 validation step against the JAX one, on the
CPU at tiny size.

- port save -> port load is exact, AdamW states included;
- a JAX ``save_checkpoint`` -> port load equals ``load_jax_params`` of the
  same tree, and a port save -> JAX ``load_checkpoint`` gives the port's
  net leaves exactly (and no optimizer state for an optax template);
- ``convert_reference_checkpoint`` and ``load_pretrained_encoders`` equal
  the JAX conversions leaf for leaf on files the tests write;
- two epochs straight through equal the same run split at epoch 1 and
  resumed, to 1e-6, with dropout on and the TMA phase in the second epoch;
- ``make_stage1_val_step`` equals the JAX one at 1e-5 relative.
"""

import copy
import dataclasses
import logging
import math
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io.wavfile as sw
import torch

from styletts2_tpu.models.decoder import istftnet as j_istftnet
from styletts2_tpu.train import checkpoint as j_ckpt
from styletts2_tpu.train.validate import make_stage1_val_step as j_make_val_step
from styletts2_tpu_torch.config import Config, ModelParams
from styletts2_tpu_torch.models.decoder import istftnet as t_istftnet
from styletts2_tpu_torch.models.plbert import PLBertConfig
from styletts2_tpu_torch.models.zoo import (STAGE1_TMA_NETS, build_nets, export_params,
                                            flatten, init_reference_, load_jax_params)
from styletts2_tpu_torch.train import checkpoint as t_ckpt
from styletts2_tpu_torch.train.loop import make_lr_map, run_stage1
from styletts2_tpu_torch.train.optimizers import MultiOptimizer
from styletts2_tpu_torch.train.validate import make_stage1_val_step

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_aux import J_ASR, J_JDC, stage1_tiny  # noqa: E402
from test_torch_stage1 import _canonical_phase, make_batch, sharp_tiny, torch_batch  # noqa: E402
from test_torch_tma import tma_nets  # noqa: E402

torch.set_num_threads(1)

LP = Config().loss_params


def _trained(nets, seed=0):
    """A copy of ``nets`` and a MultiOptimizer over it after two updates
    with random gradients: every AdamW state is set."""
    nets = copy.deepcopy(nets)
    opt = MultiOptimizer(nets, make_lr_map(Config()))
    g = torch.Generator().manual_seed(seed)
    for _ in range(2):
        for p in nets.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step(list(nets))
    return nets, opt


def _assert_nets_equal(a, b):
    for name in a:
        sa, sb = a[name].state_dict(), b[name].state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"


def _assert_adamw_equal(a: MultiOptimizer, b: MultiOptimizer):
    for name in a.opts:
        pa, pb = list(a.nets[name].parameters()), list(b.nets[name].parameters())
        for x, y in zip(pa, pb):
            sa, sb = a.opts[name].state.get(x, {}), b.opts[name].state.get(y, {})
            assert sorted(sa) == sorted(sb)
            for k in sa:
                assert torch.equal(sa[k], sb[k]), (name, k)


def test_port_save_load_exact(tmp_path):
    _, nets, *_ = stage1_tiny()
    nets, opt = _trained(nets)
    path = t_ckpt.save_checkpoint(str(tmp_path / "ck"), nets, opt, epoch=3, iters=77,
                                  extra={"note": 1})
    assert path.endswith("ck.npz") and os.path.exists(path + t_ckpt.META_SUFFIX)
    fresh = copy.deepcopy(nets)
    init_reference_(fresh, torch.Generator().manual_seed(1))
    fresh_opt = MultiOptimizer(fresh, make_lr_map(Config()))
    params, epoch, iters, extra = t_ckpt.load_checkpoint(path, fresh, fresh_opt)
    assert (epoch, iters, extra) == (3, 77, {"note": 1})
    assert sorted(params) == sorted(nets)
    _assert_nets_equal(nets, fresh)
    _assert_adamw_equal(opt, fresh_opt)
    assert all(len(o.state) for o in fresh_opt.opts.values())
    # the loaded moments carry on as the saved ones would
    for p, q in zip(nets.parameters(), fresh.parameters()):
        p.grad = q.grad = torch.full_like(p, 0.5)
    opt.step(list(nets))
    fresh_opt.step(list(fresh))
    _assert_nets_equal(nets, fresh)


def test_jax_checkpoint_loads_into_the_port(tmp_path, caplog):
    zoo, nets, *_ = stage1_tiny()
    opt_states = optax.adamw(1e-4).init(zoo)
    j_ckpt.save_checkpoint(str(tmp_path / "jax.npz"), zoo, opt_states, epoch=2, iters=9)
    fresh = copy.deepcopy(nets)
    init_reference_(fresh, torch.Generator().manual_seed(2))
    opt = MultiOptimizer(fresh, make_lr_map(Config()))
    with caplog.at_level(logging.WARNING):
        _, epoch, iters, _ = t_ckpt.load_checkpoint(str(tmp_path / "jax.npz"), fresh, opt)
    assert (epoch, iters) == (2, 9)
    assert "opt.*" in caplog.text
    assert all(not o.state for o in opt.opts.values())
    _assert_nets_equal(load_jax_params(copy.deepcopy(nets), zoo), fresh)


def test_port_checkpoint_loads_into_jax(tmp_path):
    zoo, nets, *_ = stage1_tiny()
    nets, opt = _trained(nets)
    path = t_ckpt.save_checkpoint(str(tmp_path / "port.npz"), nets, opt, epoch=1, iters=5)
    params, opt_states, epoch, iters, _ = j_ckpt.load_checkpoint(
        path, zoo, opt_template=optax.adamw(1e-4).init(zoo))
    assert opt_states is None and (epoch, iters) == (1, 5)
    want = flatten(export_params(nets))
    got = flatten(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_convert_reference_checkpoint_as_jax(tmp_path):
    """A reference-format ``.pth``: ``module.`` prefixes, the diffusion
    denoiser stored twice (``unet.`` and ``diffusion.net.``, the second a
    different copy that must lose), and a vocabulary grown from 170 to 179
    tokens in the text encoder's embedding."""
    mp = ModelParams(dim_in=4, hidden_dim=32, max_conv_dim=32, n_layer=1, n_token=179,
                     max_dur=10, style_dim=16)
    mp = dataclasses.replace(mp, diffusion=dataclasses.replace(
        mp.diffusion, transformer=dataclasses.replace(mp.diffusion.transformer, num_layers=1,
                                                      num_heads=2, head_features=8)))
    pl = PLBertConfig(vocab_size=179, embedding_size=8, hidden_size=24, num_attention_heads=2,
                      intermediate_size=32, max_position_embeddings=64, num_hidden_layers=1)
    nets = init_reference_(build_nets(mp, pl, nets=("text_encoder", "bert_encoder",
                                                     "diffusion")),
                           torch.Generator().manual_seed(0))
    current = export_params(nets)
    g = torch.Generator().manual_seed(1)
    state = {"text_encoder": {}, "bert_encoder": {}, "diffusion": {}}
    for name in ("text_encoder", "bert_encoder"):
        for k, v in nets[name].state_dict().items():
            t = torch.randn(v.shape, generator=g)
            state[name]["module." + k] = t[:170] if k == "embedding.weight" else t
    for k, v in nets["diffusion"].state_dict().items():
        k = k[len("transformer."):]
        state["diffusion"]["unet." + k] = torch.randn(v.shape, generator=g)
        state["diffusion"]["diffusion.net." + k] = torch.randn(v.shape, generator=g)
    path = str(tmp_path / "ref.pth")
    torch.save({"net": state, "epoch": 5, "iters": 100}, path)

    ours = t_ckpt.convert_reference_checkpoint(path, current)
    theirs = j_ckpt.convert_reference_checkpoint(path, current)
    assert sorted(ours) == sorted(theirs) == ["bert_encoder", "diffusion", "text_encoder"]
    got, want = flatten(ours), flatten(theirs)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    emb = got["text_encoder.embedding.weight"]
    np.testing.assert_array_equal(emb[170:], np.repeat(emb[169:170], 9, axis=0))
    load_jax_params(nets, ours)                 # the converted tree loads strictly


def test_load_pretrained_encoders_as_jax(tmp_path):
    """ASR/JDC/PL-BERT/Whisper files in the reference layouts (the JAX
    test's), loaded by both packages into the same starting weights."""
    _, _, _, mp, asr, jdc = stage1_tiny()
    pl = PLBertConfig(vocab_size=179, embedding_size=8, hidden_size=24, num_attention_heads=2,
                      intermediate_size=32, max_position_embeddings=64, num_hidden_layers=1)
    nets = build_nets(mp, pl, nets=("bert", "text_aligner", "pitch_extractor", "slm_encoder"),
                      asr_cfg=asr, jdc_cfg=jdc, whisper_cfg=tma_nets()[0]["slm_encoder"].cfg)
    init_reference_(nets, torch.Generator().manual_seed(0))
    start = copy.deepcopy(export_params(nets))       # export_params shares the storage

    def shifted(net):
        return {k: v.detach() + 1.0 for k, v in net.state_dict().items()}

    torch.save({"model": shifted(nets["text_aligner"])}, tmp_path / "asr.pth")
    torch.save({"net": shifted(nets["pitch_extractor"])}, tmp_path / "jdc.t7")
    (tmp_path / "plbert").mkdir()
    torch.save({"net": {"module.encoder." + k: v for k, v in shifted(nets["bert"]).items()}},
               tmp_path / "plbert" / "step_100.t7")
    torch.save({"net": {"module.encoder." + k: v * 0 for k, v in shifted(nets["bert"]).items()}},
               tmp_path / "plbert" / "step_50.t7")
    torch.save({"encoder." + k: v for k, v in shifted(nets["slm_encoder"]).items()},
               tmp_path / "whisper.pt")
    cfg = Config(ASR_path=str(tmp_path / "asr.pth"), F0_path=str(tmp_path / "jdc.t7"),
                 PLBERT_dir=str(tmp_path / "plbert"))
    cfg = dataclasses.replace(cfg, model_params=dataclasses.replace(
        mp, slm=dataclasses.replace(mp.slm, model=str(tmp_path / "whisper.pt"))))

    loaded = t_ckpt.load_pretrained_encoders(cfg, nets)
    jzoo = copy.deepcopy(start)
    j_loaded = j_ckpt.load_pretrained_encoders(cfg, jzoo)
    assert loaded == j_loaded and loaded["bert"].endswith("step_100.t7")
    got, want = flatten(export_params(nets)), flatten(jzoo)
    for k, v in flatten(start).items():
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(got[k], v + 1.0, atol=1e-6, err_msg=k)

    bad = dataclasses.replace(cfg, ASR_path=str(tmp_path / "missing.pth"))
    with pytest.raises(FileNotFoundError, match="STYLETTS2_ALLOW_RANDOM_ENCODERS"):
        t_ckpt.load_pretrained_encoders(bad, nets)
    hub = dataclasses.replace(cfg, model_params=mp)          # "openai/whisper-base"
    with pytest.raises(FileNotFoundError, match="slm_encoder"):
        t_ckpt.load_pretrained_encoders(hub, nets)
    assert "slm_encoder" not in t_ckpt.load_pretrained_encoders(hub, nets, allow_random=True)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Two epochs (the second from TMA on, dropout on, validation after
    each) straight through, against the same run stopped after epoch 0 and
    resumed from ``epoch_1st_00000.npz``: the same parameters to 1e-6."""
    nets, _, _ = tma_nets()
    _, _, _, mp, _, _ = stage1_tiny()
    configs = {"model": mp, "whisper": nets["slm_encoder"].cfg}

    def loader(epoch):
        return iter([make_batch(epoch), make_batch(epoch + 5)])

    def val_loader(epoch):
        return iter([make_batch(9)])

    def run(log_dir, epochs, resume_from=None):
        cfg = Config(log_interval=1, max_len=80, epochs_1st=epochs, save_freq=1,
                     log_dir=str(log_dir), first_stage_path="first_stage.npz",
                     loss_params=dataclasses.replace(LP, TMA_epoch=1))
        logs = []
        state = run_stage1(cfg, configs, run_nets, loader, val_loader,
                           log_cb=lambda it, m: logs.append((it, m)), resume_from=resume_from,
                           device="cpu", seed=0)
        return state, logs

    run_nets = copy.deepcopy(nets)
    straight, logs = run(tmp_path / "a", 2)
    straight_nets = run_nets
    run_nets = copy.deepcopy(nets)
    first, first_logs = run(tmp_path / "b", 1)
    assert (first.epoch, first.iters) == (1, 2)
    run_nets = copy.deepcopy(nets)
    init_reference_(run_nets, torch.Generator().manual_seed(3))     # overwritten at load
    resumed, resumed_logs = run(tmp_path / "b", 2, str(tmp_path / "b" / "epoch_1st_00000.npz"))
    assert (straight.epoch, straight.iters) == (resumed.epoch, resumed.iters) == (2, 4)
    assert [it for it, _ in logs] == [1, 2, 2, 3, 4, 4]
    assert logs == first_logs + resumed_logs
    assert "d_loss" in logs[3][1] and set(logs[2][1]) == {"val_mel_loss"}
    for name in STAGE1_TMA_NETS:
        for (k, a), b in zip(straight_nets[name].state_dict().items(),
                             run_nets[name].state_dict().values()):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{name}.{k}")
    for tag in ("a", "b"):
        assert os.path.exists(tmp_path / tag / "epoch_1st_00001.npz")
        assert os.path.exists(tmp_path / tag / "first_stage.npz")


def _conditioned_phase(stft_mag_phase, where):
    """The harmonic source's phases with the ill-posed ones fixed alike in
    both packages, for the validation test only.  Validation runs the
    decoder without dither, and the random pitch extractor gives unvoiced F0,
    so the source is a constant (``tanh`` of the merge's bias): every bin but
    DC holds ~1e-7 of rounding, whose ``atan2`` phases differ between
    ``torch.stft`` and JAX's FFT by up to 2 pi, and DC sits on the branch cut
    where the constant is negative.  Bins under 1e-5 of the largest
    magnitude take phase 0, and phases within 1e-4 of -pi take +pi
    (``test_torch_stage1._canonical_phase``)."""
    canonical = _canonical_phase(stft_mag_phase, where)

    def wrapped(*args, **kw):
        mag, phase = canonical(*args, **kw)
        return mag, where(mag <= 1e-5 * mag.max(), 0.0 * phase, phase)
    return wrapped


@pytest.fixture(scope="module")
def jax_val_step():
    """The JAX validation step, traced with ``_conditioned_phase``."""
    j_orig = j_istftnet.stft_mag_phase
    j_istftnet.stft_mag_phase = _conditioned_phase(j_orig, jnp.where)
    try:
        zoo, nets, jmp, mp = sharp_tiny()
        step = j_make_val_step(Config(), {"model": jmp, "asr": J_ASR, "jdc": J_JDC}, 40)
        batch = {k: jnp.asarray(v) for k, v in make_batch(3).items()}
        key = jax.random.PRNGKey(7)
        loss = float(step(zoo, batch, key)["mel_loss"])
        yield loss, np.asarray(jax.random.uniform(key, (2,))), nets
    finally:
        j_istftnet.stft_mag_phase = j_orig


def test_stage1_val_step_matches_jax(jax_val_step, monkeypatch):
    loss, u, nets = jax_val_step
    monkeypatch.setattr(t_istftnet, "stft_mag_phase",
                        _conditioned_phase(t_istftnet.stft_mag_phase, torch.where))
    out = make_stage1_val_step(Config(), {}, 40)(nets, torch_batch(make_batch(3)),
                                                 torch.from_numpy(u))
    assert sorted(out) == ["mel_loss"] and math.isfinite(loss)
    np.testing.assert_allclose(float(out["mel_loss"]), loss, rtol=1e-5)


def _write_corpus(root, n, rng, prefix):
    lines = []
    for i in range(n):
        sr = 22050 if i % 2 else 24000
        wave = (0.1 * rng.standard_normal(int(sr * (0.7 + 0.05 * i))) * 32767).astype(np.int16)
        sw.write(root / f"{prefix}{i}.wav", sr, wave)
        lines.append(f"{prefix}{i}.wav|ðə kʌmɪʃən ɹɪvjuːd ðə ɛvɪdəns {i}.|0\n")
    (root / f"{prefix}_list.txt").write_text("".join(lines))


def test_train_stage1_entry_point_on_cpu(tmp_path, monkeypatch):
    """``python -m styletts2_tpu_torch.train_stage1``: CUDA by default (it
    raises here, where there is none), a missing encoder raises unless
    random encoders are asked for, ``--device cpu`` trains from the files
    (validation, checkpoints, metrics), and a second call resumes from the
    newest epoch checkpoint."""
    import yaml

    from styletts2_tpu_torch.train_stage1 import find_resume_checkpoint, main

    rng = np.random.default_rng(0)
    _write_corpus(tmp_path, 4, rng, "train")
    _write_corpus(tmp_path, 2, rng, "val")
    spec = {"log_dir": str(tmp_path / "logs"), "first_stage_path": "first_stage.npz",
            "epochs_1st": 1, "save_freq": 1, "log_interval": 1, "batch_size": 2,
            "max_len": 80, "ASR_path": str(tmp_path / "no_asr.pth"),
            "data_params": {"train_data": str(tmp_path / "train_list.txt"),
                            "val_data": str(tmp_path / "val_list.txt"),
                            "root_path": str(tmp_path), "OOD_data": "", "num_workers": 2},
            "model_params": {"dim_in": 4, "hidden_dim": 32, "max_conv_dim": 32, "n_layer": 1,
                             "max_dur": 10, "style_dim": 16,
                             "decoder": {"upsample_initial_channel": 32}},   # width 64
            "loss_params": {"TMA_epoch": 5}}
    yml = tmp_path / "tiny.yml"
    yml.write_text(yaml.safe_dump(spec))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--config_path", str(yml)])
    with pytest.raises(FileNotFoundError, match="text_aligner"):
        main(["--config_path", str(yml), "--device", "cpu"])
    logs = []
    args = ["--config_path", str(yml), "--device", "cpu"]
    monkeypatch.setenv("STYLETTS2_ALLOW_RANDOM_ENCODERS", "1")
    state = main(args, log_cb=lambda it, m: logs.append((it, m)))
    assert (state.epoch, state.iters) == (1, 2) and len(state.data_wait_s) == 2
    assert [it for it, _ in logs] == [1, 2, 2] and "val_mel_loss" in logs[2][1]
    assert all(math.isfinite(v) for _, m in logs for v in m.values())
    assert find_resume_checkpoint(spec["log_dir"], "1st").endswith("epoch_1st_00000.npz")
    assert os.path.exists(tmp_path / "logs" / "first_stage.npz")
    assert len((tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()) == 3

    spec["epochs_1st"] = 2
    yml.write_text(yaml.safe_dump(spec))
    state = main(args)
    assert (state.epoch, state.iters) == (2, 4)
    assert find_resume_checkpoint(spec["log_dir"], "1st").endswith("epoch_1st_00001.npz")
