"""The stage-1 training driver (the port of the JAX package's
``train/loop.py::run_stage1``), before and from ``TMA_epoch``.

The host loop owns epochs, batches and the clip-length buckets; each step is
``Stage1Trainer.step`` on one device.  Checkpointing, validation, resume
and data parallelism are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from .optimizers import MultiOptimizer
from .stage1 import Stage1Trainer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    nets: nn.ModuleDict
    optimizer: MultiOptimizer
    epoch: int = 0
    iters: int = 0


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


def run_stage1(cfg: Config, configs: Dict, nets: nn.ModuleDict, train_loader,
               max_steps: Optional[int] = None,
               log_cb: Optional[Callable[[int, Dict], None]] = None,
               device=None, seed: int = 0) -> TrainState:
    """Train ``nets`` in place: the ``models.zoo.STAGE1_NETS``, and the
    ``STAGE1_TMA_NETS`` when the run reaches ``cfg.loss_params.TMA_epoch``.

    ``train_loader(epoch)`` yields batches of numpy arrays: ``waves`` (B,
    T_wav) f32, ``mel_input_length`` (B,), ``texts`` (B, T_text) and
    ``input_lengths`` (B,).  ``configs`` holds ``model`` (ModelParams) and
    ``whisper`` (the ``slm_encoder``'s WhisperConfig, default Whisper-base).
    Batches whose clip would be under 40 aligner frames are skipped (the
    style encoder needs 80 mel frames).
    """
    dev = _device(device)
    nets.to(dev)
    opt = MultiOptimizer(nets, make_lr_map(cfg), default_lr=cfg.optimizer_params.lr)
    trainer = Stage1Trainer(cfg, configs, nets, opt)
    state = TrainState(nets, opt)
    generator = torch.Generator(dev).manual_seed(seed)
    steps_done = 0
    for epoch in range(state.epoch, cfg.epochs_1st):
        tma = epoch >= cfg.loss_params.TMA_epoch
        t0 = time.time()
        for batch in train_loader(epoch):
            mel_len = _bucket(_clip_lengths(np.asarray(batch["mel_input_length"]),
                                            cfg.max_len))
            if mel_len < 40:
                continue
            step = trainer.make_step(tma, mel_len, mel_len)
            tb = {"waves": torch.as_tensor(np.asarray(batch["waves"], np.float32), device=dev)}
            for k in ("mel_input_length", "texts", "input_lengths"):
                tb[k] = torch.as_tensor(np.asarray(batch[k]), device=dev).long()
            metrics = step(tb, generator=generator)
            state.iters += 1
            steps_done += 1
            if log_cb and state.iters % cfg.log_interval == 0:
                log_cb(state.iters, {k: float(v) for k, v in metrics.items()})
            if max_steps and steps_done >= max_steps:
                return state
        state.epoch = epoch + 1
        logger.info("stage1 epoch %d done in %.1fs", epoch, time.time() - t0)
    return state
