"""Stage-1 training entry point (the port of ``train_stage1.py``; ref:
train_first.py).

    python -m styletts2_tpu_torch.train_stage1 --config_path configs/ljspeech.yml

Reads the train and validation lists (``wav|phonemes|speaker`` lines) and
their audio under ``data_params.root_path``, builds the stage-1 nets
(``models.zoo.STAGE1_TMA_NETS`` when the run reaches ``TMA_epoch``, else
``STAGE1_NETS``) and the frozen ones its sample dumps read
(``STAGE1_SAMPLE_NETS``) with the reference's initialisation, loads the
pretrained aligner, pitch extractor, PL-BERT and Whisper encoder (a missing
file raises unless ``STYLETTS2_ALLOW_RANDOM_ENCODERS=1``), then a resume or pretrained
checkpoint, and trains with ``train.loop.run_stage1`` on the card
(``--device cpu`` for the CPU).  Metrics go to ``<log_dir>/metrics.jsonl``,
checkpoints to ``<log_dir>/epoch_1st_*.npz`` and ``first_stage_path``.
Single-speaker (iSTFTNet) and multispeaker (HiFi-GAN,
``configs/libritts.yml``) models alike.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import logging
import os
from typing import Callable, Dict, Optional, Sequence

INIT_SEED = 0


def find_resume_checkpoint(log_dir: str, stage_tag: str) -> Optional[str]:
    """Latest ``epoch_{tag}_*.npz`` in the run directory, if any."""
    paths = sorted(glob.glob(os.path.join(log_dir, f"epoch_{stage_tag}_*.npz")))
    return paths[-1] if paths else None


def grow_n_token(cfg):
    """Auto-grow the model vocab from a custom phoneme dictionary
    (ref: train_first.py:237-246, models.py:989-996)."""
    from .text.dictionary import (infer_phoneme_dictionary_token_count,
                                  resolve_phoneme_dictionary_settings)

    dp = cfg.data_params
    source, dict_cfg = resolve_phoneme_dictionary_settings(
        {"phoneme_dict_path": dp.phoneme_dict_path,
         "phoneme_dictionary_config": dp.phoneme_dictionary_config})
    n = infer_phoneme_dictionary_token_count(source, dict_cfg)
    if n and n > cfg.model_params.n_token:
        logging.info("growing n_token %d -> %d from phoneme dictionary",
                     cfg.model_params.n_token, n)
        cfg = dataclasses.replace(
            cfg, model_params=dataclasses.replace(cfg.model_params, n_token=n))
    return cfg


def build_loaders(cfg):
    """The train and validation loaders of ``cfg.data_params``'s lists."""
    from .data import build_dataloader

    dp = cfg.data_params
    with open(dp.train_data, encoding="utf-8", errors="ignore") as f:
        train_list = f.readlines()
    with open(dp.val_data, encoding="utf-8", errors="ignore") as f:
        val_list = f.readlines()
    train_loader = build_dataloader(
        train_list, dp.root_path, OOD_data=dp.OOD_data, min_length=dp.min_length,
        batch_size=cfg.batch_size, num_workers=dp.num_workers,
        prefetch_batches=dp.prefetch_batches)
    val_loader = build_dataloader(
        val_list, dp.root_path, validation=True, OOD_data=dp.OOD_data,
        batch_size=cfg.batch_size, num_workers=min(2, dp.num_workers))
    return train_loader, val_loader


def metrics_logger(writer, log_cb: Optional[Callable[[int, Dict], None]] = None):
    """``log_cb`` for a training loop: each metrics line to ``writer`` and
    the log, then to ``log_cb``."""
    def write(step, metrics):
        writer.add_scalars(step, metrics)
        logging.info("step %d | %s", step,
                     " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if log_cb is not None:
            log_cb(step, metrics)
    return write


def main(argv: Optional[Sequence[str]] = None,
         log_cb: Optional[Callable[[int, Dict], None]] = None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and train; returns the
    final ``TrainState``.  ``log_cb(iters, metrics)`` is called after each
    metrics line is written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", default="configs/ljspeech.yml")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint to resume from (default: latest epoch_1st_* in log_dir)")
    ap.add_argument("--no_resume", action="store_true",
                    help="ignore existing epoch checkpoints, start fresh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)

    import torch

    from .config import load_config
    from .models.whisper import WhisperConfig
    from .models.zoo import (STAGE1_NETS, STAGE1_SAMPLE_NETS, STAGE1_TMA_NETS, build_nets,
                             export_params, init_reference_, load_jax_params)
    from .train.checkpoint import (convert_reference_checkpoint, load_checkpoint,
                                   load_pretrained_encoders)
    from .train.loop import run_stage1
    from .utils import MetricsWriter

    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("train_stage1 runs on CUDA by default and no CUDA device is "
                           "available; pass --device cpu explicitly")
    device = torch.device(args.device or "cuda")
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config_path)
    os.makedirs(cfg.log_dir, exist_ok=True)
    cfg = grow_n_token(cfg)

    train_loader, val_loader = build_loaders(cfg)

    tma = cfg.epochs_1st > cfg.loss_params.TMA_epoch
    configs = {"model": cfg.model_params, "whisper": WhisperConfig()}
    nets = build_nets(cfg.model_params,
                      nets=(STAGE1_TMA_NETS if tma else STAGE1_NETS) + STAGE1_SAMPLE_NETS,
                      whisper_cfg=configs["whisper"])
    init_reference_(nets, torch.Generator().manual_seed(INIT_SEED))

    # mid-run resume takes precedence over pretrained-model init
    resume_from = None
    if not args.no_resume:
        resume_from = args.resume or find_resume_checkpoint(cfg.log_dir, "1st")
        if resume_from is None and cfg.pretrained_model and \
                not cfg.load_only_params and \
                not cfg.pretrained_model.endswith(".pth") and \
                os.path.exists(cfg.pretrained_model):
            resume_from = cfg.pretrained_model

    # pretrained frozen encoders (ASR/F0/Whisper) are the base init; any
    # resume/pretrained checkpoint below overwrites where present
    # (ref: train_first.py:208-227, losses.py:204-214)
    loaded = load_pretrained_encoders(cfg, nets)
    for name, src in loaded.items():
        logging.info("loaded pretrained %s from %s", name, src)
    if resume_from is None and cfg.pretrained_model and os.path.exists(cfg.pretrained_model):
        if cfg.pretrained_model.endswith(".pth"):
            converted = convert_reference_checkpoint(cfg.pretrained_model, export_params(nets))
            load_jax_params({n: nets[n] for n in converted if n in nets}, converted)
        else:
            load_checkpoint(cfg.pretrained_model, nets)

    writer = MetricsWriter(cfg.log_dir)
    try:
        return run_stage1(cfg, configs, nets, train_loader, val_loader,
                          max_steps=args.max_steps, log_cb=metrics_logger(writer, log_cb),
                          resume_from=resume_from,
                          device=device, seed=INIT_SEED)
    finally:
        writer.close()


if __name__ == "__main__":
    main()
