"""The stage-1 training driver (the port of the JAX package's
``train/loop.py::run_stage1``), before and from ``TMA_epoch``.

The host loop owns epochs, batches, the clip-length buckets, validation,
checkpoints and resume; each step is ``Stage1Trainer.step`` on one device.
Step ``iters`` draws its noise from a generator seeded by ``(seed, iters)``,
the counterpart of the JAX loop's ``fold_in(key, iters)``, so a resumed run
draws what an uninterrupted one draws.  Data parallelism is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from .checkpoint import load_checkpoint, save_checkpoint
from .optimizers import MultiOptimizer
from .stage1 import Stage1Trainer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    nets: nn.ModuleDict
    optimizer: MultiOptimizer
    epoch: int = 0
    iters: int = 0
    # host seconds spent waiting on train_loader for each batch of this run
    data_wait_s: List[float] = dataclasses.field(default_factory=list)


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
            raise RuntimeError("run_stage1 runs on CUDA by default and no CUDA device is "
                               "available; pass device='cpu' explicitly")
        return torch.device("cuda")
    return torch.device(device)


TRAIN_STREAM, VAL_STREAM = 0, 1


def seeded_generator(seed: int, index: int, device, stream: int = TRAIN_STREAM
                     ) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, stream, index)`` alone:
    step ``iters`` draws its noise from ``seeded_generator(seed, iters,
    dev)``, epoch ``epoch``'s validation its clip starts from
    ``seeded_generator(seed, epoch, dev, VAL_STREAM)``."""
    state = np.random.SeedSequence([seed, stream, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


def to_device(batch: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The step's tensors of a numpy batch: ``waves`` f32, the lengths and
    tokens int64."""
    tb = {"waves": torch.as_tensor(np.asarray(batch["waves"], np.float32), device=dev)}
    for k in ("mel_input_length", "texts", "input_lengths"):
        tb[k] = torch.as_tensor(np.asarray(batch[k]), device=dev).long()
    return tb


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
    ``cfg.save_freq`` epochs a checkpoint ``epoch_1st_{epoch:05d}.npz`` in
    ``cfg.log_dir`` holding the next epoch to run; at the end, one to
    ``cfg.first_stage_path`` there.  A run cut by ``max_steps`` saves
    nothing.
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
        batches = iter(train_loader(epoch))
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            state.data_wait_s.append(time.perf_counter() - t_wait)
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
            _run_validation(cfg, configs, state, val_loader, epoch, log_cb, dev, seed)
        if cfg.log_dir and (epoch + 1) % cfg.save_freq == 0:
            save_checkpoint(os.path.join(cfg.log_dir, f"epoch_1st_{epoch:05d}.npz"), nets, opt,
                            state.epoch, state.iters)
    if cfg.log_dir:
        save_checkpoint(os.path.join(cfg.log_dir, cfg.first_stage_path), nets, opt,
                        state.epoch, state.iters)
    return state


def _run_validation(cfg: Config, configs: Dict, state: TrainState, val_loader, epoch: int,
                    log_cb, dev: torch.device, seed: int = 0) -> Dict[str, float]:
    """The mean of ``make_stage1_val_step``'s losses over ``val_loader(epoch)``
    (ref: train_first.py:457-545), logged as ``val_*`` at ``state.iters``;
    the clip starts come from a generator seeded by ``(seed, epoch)``."""
    from .validate import make_stage1_val_step

    totals: Dict[str, float] = {}
    count = 0
    steps: Dict = {}
    generator = seeded_generator(seed, epoch, dev, VAL_STREAM)
    for batch in val_loader(epoch):
        mel_len = _bucket(_clip_lengths(np.asarray(batch["mel_input_length"]), cfg.max_len))
        if mel_len < 40:
            continue
        if mel_len not in steps:
            steps[mel_len] = make_stage1_val_step(cfg, configs, mel_len)
        tb = to_device(batch, dev)
        clip_u = torch.rand((tb["texts"].shape[0],), generator=generator, device=dev)
        for k, v in steps[mel_len](state.nets, tb, clip_u).items():
            totals[k] = totals.get(k, 0.0) + float(v)
        count += 1
    means = {f"val_{k}": v / count for k, v in totals.items()} if count else {}
    if means and log_cb:
        log_cb(state.iters, means)
    return means
