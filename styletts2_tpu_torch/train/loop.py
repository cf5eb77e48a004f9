"""The training drivers (the port of the JAX package's ``train/loop.py``):
``run_stage1``, before and from ``TMA_epoch``, and ``run_stage2``, across
``diff_epoch`` and ``joint_epoch``.

The host loop owns epochs, batches, the clip-length buckets, validation,
checkpoints and resume; each step is ``Stage1Trainer.step`` or
``Stage2Trainer.step`` on one device.  Step ``iters`` draws its noise from a
generator seeded by ``(seed, iters)``, the counterpart of the JAX loop's
``fold_in(key, iters)``, and stage 2's host draws (the sampler's step count
and the SLM adversarial pass's choices) from a numpy generator seeded the
same way, so a resumed run draws what an uninterrupted one draws.  Data
parallelism is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from .checkpoint import load_checkpoint, save_checkpoint
from .optimizers import MultiOptimizer
from .stage1 import Stage1Trainer
from .stage2 import Stage2Phase, Stage2Trainer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    nets: nn.ModuleDict
    optimizer: MultiOptimizer
    epoch: int = 0
    iters: int = 0
    # host seconds spent waiting on train_loader for each batch of this run
    data_wait_s: List[float] = dataclasses.field(default_factory=list)
    # stage 2: the diffusion's sigma_data estimate, carried from step to step
    sigma_data: float = 0.2


def _clip_lengths(mel_lengths: np.ndarray, max_len: int) -> int:
    """This batch's clip length in aligner frames: the batch minimum of
    ``mel_len // 2 - 1``, capped at ``max_len // 2`` (ref: train_first.py:348-350)."""
    return max(2, min(int(mel_lengths.min()) // 2 - 1, max_len // 2))


def _bucket(n: int, m: int = 4) -> int:
    return max(m, (n // m) * m)


def make_lr_map(cfg: Config) -> Dict[str, float]:
    op = cfg.optimizer_params
    return {"bert": op.bert_lr,
            "decoder": op.ft_lr if cfg.pretrained_model else op.lr,
            "style_encoder": op.ft_lr if cfg.pretrained_model else op.lr}


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the trainers run on CUDA by default and no CUDA device is "
                               "available; pass device='cpu' explicitly")
        return torch.device("cuda")
    return torch.device(device)


TRAIN_STREAM, VAL_STREAM, HOST_STREAM = 0, 1, 2


def seeded_generator(seed: int, index: int, device, stream: int = TRAIN_STREAM
                     ) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, stream, index)`` alone:
    step ``iters`` draws its noise from ``seeded_generator(seed, iters,
    dev)``, epoch ``epoch``'s validation its clip starts from
    ``seeded_generator(seed, epoch, dev, VAL_STREAM)``."""
    state = np.random.SeedSequence([seed, stream, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


def to_device(batch: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The step's tensors of a numpy batch: the waveforms f32, the lengths
    and tokens int64 (the reference texts and the same-speaker reference
    clips too, where the batch has them)."""
    tb = {}
    for k in ("waves", "ref_waves"):
        if k in batch:
            tb[k] = torch.as_tensor(np.asarray(batch[k], np.float32), device=dev)
    for k in ("mel_input_length", "texts", "input_lengths", "ref_texts", "ref_lengths",
              "ref_frame_lengths"):
        if k in batch:
            tb[k] = torch.as_tensor(np.asarray(batch[k]), device=dev).long()
    return tb


def _batches(state: TrainState, loader):
    """The loader's batches, each wait on it appended to ``state.data_wait_s``."""
    batches = iter(loader)
    while True:
        t_wait = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            return
        state.data_wait_s.append(time.perf_counter() - t_wait)
        yield batch


def run_stage1(cfg: Config, configs: Dict, nets: nn.ModuleDict, train_loader,
               val_loader=None, max_steps: Optional[int] = None,
               log_cb: Optional[Callable[[int, Dict], None]] = None,
               resume_from: Optional[str] = None, device=None, seed: int = 0
               ) -> TrainState:
    """Train ``nets`` in place: the ``models.zoo.STAGE1_NETS``, and the
    ``STAGE1_TMA_NETS`` when the run reaches ``cfg.loss_params.TMA_epoch``.

    ``train_loader(epoch)`` and ``val_loader(epoch)`` yield batches of numpy
    arrays: ``waves`` (B, T_wav) f32, ``mel_input_length`` (B,), ``texts``
    (B, T_text) and ``input_lengths`` (B,) (``data.build_dataloader``).
    ``configs`` holds ``model`` (ModelParams) and ``whisper`` (the
    ``slm_encoder``'s WhisperConfig, default Whisper-base).  Batches whose
    clip would be under 40 aligner frames are skipped (the style encoder
    needs 80 mel frames).

    ``resume_from``: a checkpoint whose nets, AdamW states, ``epoch`` and
    ``iters`` the run continues from.  After each epoch: validation on
    ``val_loader`` (``val_mel_loss`` to ``log_cb``), and every
    ``cfg.save_freq`` epochs a sample dump (which also reads the frozen
    ``models.zoo.STAGE1_SAMPLE_NETS``, as ``train_stage1`` builds them) and
    a checkpoint ``epoch_1st_{epoch:05d}.npz`` in ``cfg.log_dir`` holding
    the next epoch to run; at the end, one to ``cfg.first_stage_path``
    there.  A run cut by ``max_steps`` saves nothing.
    """
    dev = _device(device)
    nets.to(dev)
    opt = MultiOptimizer(nets, make_lr_map(cfg), default_lr=cfg.optimizer_params.lr)
    trainer = Stage1Trainer(cfg, configs, nets, opt)
    state = TrainState(nets, opt)
    if resume_from:
        _, state.epoch, state.iters, _ = load_checkpoint(resume_from, nets, opt)
        logger.info("resumed stage1 from %s at epoch %d, iter %d", resume_from,
                    state.epoch, state.iters)
    steps_done = 0
    for epoch in range(state.epoch, cfg.epochs_1st):
        tma = epoch >= cfg.loss_params.TMA_epoch
        t0 = time.time()
        for batch in _batches(state, train_loader(epoch)):
            mel_len = _bucket(_clip_lengths(np.asarray(batch["mel_input_length"]),
                                            cfg.max_len))
            if mel_len < 40:
                continue
            step = trainer.make_step(tma, mel_len, mel_len)
            metrics = step(to_device(batch, dev),
                           generator=seeded_generator(seed, state.iters, dev))
            state.iters += 1
            steps_done += 1
            if log_cb and state.iters % cfg.log_interval == 0:
                log_cb(state.iters, {k: float(v) for k, v in metrics.items()})
            if max_steps and steps_done >= max_steps:
                return state
        state.epoch = epoch + 1
        logger.info("stage1 epoch %d done in %.1fs", epoch, time.time() - t0)
        if val_loader is not None:
            _run_validation(cfg, configs, state, val_loader, epoch, log_cb, dev, seed, stage=1)
        if cfg.log_dir and (epoch + 1) % cfg.save_freq == 0:
            save_checkpoint(os.path.join(cfg.log_dir, f"epoch_1st_{epoch:05d}.npz"), nets, opt,
                            state.epoch, state.iters)
    if cfg.log_dir:
        save_checkpoint(os.path.join(cfg.log_dir, cfg.first_stage_path), nets, opt,
                        state.epoch, state.iters)
    return state


def host_draws(seed: int, iters: int, i: int, joint: bool, slm_iter: int
               ) -> Tuple[int, bool, bool, bool, bool]:
    """Stage 2's host draws of step ``iters`` (the ``i``-th batch of its
    epoch), in the JAX loop's order and with its short-circuits
    (``styletts2_tpu/train/loop.py:176-182``): the sampler's step count in
    {3, 4}, the SLM discriminator step on every ``slm_iter``-th batch, the
    ground-truth style instead of a sampled one, and the discriminator
    step's two choices.  The JAX loop draws them from one stream that a
    resume restarts; here each step's come from ``(seed, iters)`` alone."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, HOST_STREAM, iters]))
    num_steps = int(rng.integers(3, 5))
    run_disc = joint and (i + 1) % slm_iter == 0
    use_ind = joint and bool(rng.random() < 0.5)
    use_rec = run_disc and bool(rng.integers(0, 2))
    real_alt = use_rec and bool(rng.integers(0, 2))
    return num_steps, run_disc, use_ind, use_rec, real_alt


def run_stage2(cfg: Config, configs: Dict, nets: nn.ModuleDict, train_loader,
               val_loader=None, max_steps: Optional[int] = None,
               log_cb: Optional[Callable[[int, Dict], None]] = None,
               resume_from: Optional[str] = None, device=None, seed: int = 0,
               finetune: bool = False) -> TrainState:
    """Train ``nets`` (the ``models.zoo.STAGE2_NETS``) in place: the prosody
    nets, from ``cfg.loss_params.diff_epoch`` the diffusion and the MPD/MSD
    step, from ``joint_epoch`` the style encoder and decoder and the SLM
    adversarial update (``train.stage2``).  With ``finetune``, the
    fine-tune recipe (ref: train_finetune.py): ``cfg.epochs`` epochs, all of
    it from step 0, the text encoder and the aligner trained too, and the
    checkpoints tagged ``ft`` instead of ``2nd``.

    The loaders and ``configs`` as in ``run_stage1``; the batches also hold
    ``ref_texts`` (B, L) and ``ref_lengths`` (B,), the out-of-distribution
    texts, and for a multispeaker model ``ref_waves`` (B, T_ref) and
    ``ref_frame_lengths`` (B,), a clip of the same speaker
    (``data.Collater``).  ``TrainState.sigma_data`` starts at the config's
    ``diffusion.dist.sigma_data`` and carries each step's estimate.
    ``resume_from``: a checkpoint whose nets, AdamW states, ``epoch``,
    ``iters`` and ``sigma_data`` the run continues from.  After each epoch:
    validation (``val_mel_loss``, ``val_dur_loss``, ``val_F0_loss``) and,
    every ``cfg.save_freq`` epochs, a sample dump of the first validation
    batch under ``<log_dir>/samples/epoch_<epoch>`` and a checkpoint
    ``epoch_2nd_{epoch:05d}.npz`` (``epoch_ft_*``); at the end
    ``2nd_stage.npz`` (``ft_stage.npz``).  A run cut by ``max_steps`` saves
    nothing.
    """
    dev = _device(device)
    nets.to(dev)
    opt = MultiOptimizer(nets, make_lr_map(cfg), default_lr=cfg.optimizer_params.lr)
    trainer = Stage2Trainer(cfg, configs, nets, opt)
    trainer.check_nets()
    state = TrainState(nets, opt, sigma_data=cfg.model_params.diffusion.dist.sigma_data)
    if resume_from:
        _, state.epoch, state.iters, extra = load_checkpoint(resume_from, nets, opt)
        state.sigma_data = float(extra.get("sigma_data", state.sigma_data))
        logger.info("resumed stage2 from %s at epoch %d, iter %d", resume_from,
                    state.epoch, state.iters)
    lp, adv = cfg.loss_params, cfg.slmadv_params
    frame_capacity = _bucket(adv.max_len, 50)
    tag = "ft" if finetune else "2nd"
    steps_done = 0

    def save(name):
        save_checkpoint(os.path.join(cfg.log_dir, name), nets, opt, state.epoch, state.iters,
                        extra={"sigma_data": state.sigma_data})

    for epoch in range(state.epoch, cfg.epochs if finetune else cfg.epochs_2nd):
        diff = finetune or epoch >= lp.diff_epoch
        joint = finetune or epoch >= lp.joint_epoch
        t0 = time.time()
        for i, batch in enumerate(_batches(state, train_loader(epoch))):
            mel_len = _bucket(_clip_lengths(np.asarray(batch["mel_input_length"]),
                                            cfg.max_len))
            if mel_len < 40:
                continue
            num_steps, run_disc, use_ind, use_rec, real_alt = host_draws(
                seed, state.iters, i, joint, adv.iter)
            phase = Stage2Phase(diff, joint, diff, mel_len, num_steps, run_disc, use_ind,
                                use_rec, real_alt, frame_capacity, finetune)
            metrics, sigma_data = trainer.step(
                to_device(batch, dev), phase, state.sigma_data,
                generator=seeded_generator(seed, state.iters, dev))
            state.sigma_data = float(sigma_data)
            state.iters += 1
            steps_done += 1
            if log_cb and state.iters % cfg.log_interval == 0:
                log_cb(state.iters, {k: float(v) for k, v in metrics.items()})
            if max_steps and steps_done >= max_steps:
                return state
        state.epoch = epoch + 1
        logger.info("stage2 epoch %d done in %.1fs", epoch, time.time() - t0)
        if val_loader is not None:
            _run_validation(cfg, configs, state, val_loader, epoch, log_cb, dev, seed, stage=2)
        if cfg.log_dir and (epoch + 1) % cfg.save_freq == 0:
            save(f"epoch_{tag}_{epoch:05d}.npz")
    if cfg.log_dir:
        save(f"{tag}_stage.npz")
    return state


def _run_validation(cfg: Config, configs: Dict, state: TrainState, val_loader, epoch: int,
                    log_cb, dev: torch.device, seed: int = 0, stage: int = 1
                    ) -> Dict[str, float]:
    """The mean of the stage's validation losses over ``val_loader(epoch)``
    (ref: train_first.py:457-545, train_second.py:949-1068), logged as
    ``val_*`` at ``state.iters``; the clip starts come from a generator
    seeded by ``(seed, epoch)``.  Every ``cfg.save_freq`` epochs the
    samples of the first batch are written under
    ``<log_dir>/samples/epoch_<epoch>`` (``train.samples``); a dump that
    raises logs a warning and the run carries on, as in the JAX loop
    (``styletts2_tpu/train/loop.py:248-256``)."""
    from .validate import make_stage1_val_step, make_stage2_val_step

    make = make_stage1_val_step if stage == 1 else make_stage2_val_step
    totals: Dict[str, float] = {}
    count = 0
    steps: Dict = {}
    first = None
    generator = seeded_generator(seed, epoch, dev, VAL_STREAM)
    for batch in val_loader(epoch):
        mel_len = _bucket(_clip_lengths(np.asarray(batch["mel_input_length"]), cfg.max_len))
        if mel_len < 40:
            continue
        if mel_len not in steps:
            steps[mel_len] = make(cfg, configs, mel_len)
        tb = to_device(batch, dev)
        first = tb if first is None else first
        clip_u = torch.rand((tb["texts"].shape[0],), generator=generator, device=dev)
        for k, v in steps[mel_len](state.nets, tb, clip_u).items():
            totals[k] = totals.get(k, 0.0) + float(v)
        count += 1
    if first is not None and cfg.log_dir and (epoch + 1) % cfg.save_freq == 0:
        try:
            from .samples import generate_samples

            generate_samples(state.nets, first, os.path.join(cfg.log_dir, "samples",
                                                             f"epoch_{epoch:05d}"))
        except Exception as exc:   # sample dumps must never kill training
            logger.warning("sample generation failed: %s", exc)
    means = {f"val_{k}": v / count for k, v in totals.items()} if count else {}
    if means and log_cb:
        log_cb(state.iters, means)
    return means
