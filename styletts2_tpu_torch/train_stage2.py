"""Stage-2 and fine-tuning entry point (the port of ``train_stage2.py``;
ref: train_second.py, train_finetune.py).

    python -m styletts2_tpu_torch.train_stage2 --config_path configs/ljspeech.yml
    python -m styletts2_tpu_torch.train_stage2 --config_path configs/ljspeech_ft.yml --finetune

Reads the train and validation lists and their audio as stage 1 does, and
the out-of-distribution texts of ``data_params.OOD_data`` (``wav|phonemes``
or ``phonemes`` lines; without them the SLM adversarial pass speaks the
batch's own texts).  Builds every net (``models.zoo.STAGE2_NETS``) with the
reference's initialisation, loads the pretrained aligner, pitch extractor,
PL-BERT and Whisper encoder (a missing file raises unless
``STYLETTS2_ALLOW_RANDOM_ENCODERS=1``), then either resumes from the newest
``epoch_2nd_*.npz`` in ``log_dir`` (nets, AdamW, counters, ``sigma_data``)
or starts from ``pretrained_model`` (a reference ``.pth`` or a ``.npz``) or
the stage-1 checkpoint ``<log_dir>/<first_stage_path>``, nets only, copying
the style encoder into the prosody style encoder unless
``second_stage_load_pretrained``.  Trains with ``train.loop.run_stage2`` on
the card (``--device cpu`` for the CPU).  Metrics go to
``<log_dir>/metrics.jsonl``, checkpoints to ``epoch_2nd_*.npz`` and
``2nd_stage.npz``, samples to ``<log_dir>/samples``.  Single-speaker
(iSTFTNet) and multispeaker (HiFi-GAN, ``configs/libritts.yml``) models
alike.

``--finetune`` runs the fine-tune recipe (``run_stage2(finetune=True)``):
``epochs`` epochs with every net trained from step 0, resumed from the
newest ``epoch_ft_*.npz``, else started from ``pretrained_model`` (nets
only, as without ``--finetune``), with checkpoints ``epoch_ft_*.npz`` and
``ft_stage.npz`` and ``ft_lr`` for the decoder and the style encoder.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Callable, Dict, Optional, Sequence

from .train_stage1 import (INIT_SEED, build_loaders, find_resume_checkpoint, grow_n_token,
                           metrics_logger)


def main(argv: Optional[Sequence[str]] = None,
         log_cb: Optional[Callable[[int, Dict], None]] = None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and train; returns the
    final ``TrainState``.  ``log_cb(iters, metrics)`` is called after each
    metrics line is written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", default="configs/ljspeech.yml")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--finetune", action="store_true",
                    help="train_finetune.py's recipe: every net from step 0, with the "
                         "aligner's losses")
    ap.add_argument("--resume", default=None,
                    help="checkpoint to resume from (default: latest epoch_2nd_* in log_dir, "
                         "epoch_ft_* with --finetune)")
    ap.add_argument("--no_resume", action="store_true",
                    help="ignore existing epoch checkpoints, start fresh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)

    import torch

    from .config import load_config
    from .models.whisper import WhisperConfig
    from .models.zoo import STAGE2_NETS, build_nets, export_params, init_reference_, \
        load_jax_params
    from .train.checkpoint import (convert_reference_checkpoint, load_checkpoint,
                                   load_pretrained_encoders)
    from .train.loop import run_stage2
    from .utils import MetricsWriter

    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("train_stage2 runs on CUDA by default and no CUDA device is "
                           "available; pass --device cpu explicitly")
    device = torch.device(args.device or "cuda")
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config_path)
    os.makedirs(cfg.log_dir, exist_ok=True)
    cfg = grow_n_token(cfg)

    train_loader, val_loader = build_loaders(cfg)

    configs = {"model": cfg.model_params, "whisper": WhisperConfig()}
    nets = build_nets(cfg.model_params, nets=STAGE2_NETS, whisper_cfg=configs["whisper"])
    init_reference_(nets, torch.Generator().manual_seed(INIT_SEED))

    resume_from = None
    if not args.no_resume:
        resume_from = args.resume or find_resume_checkpoint(
            cfg.log_dir, "ft" if args.finetune else "2nd")

    # pretrained frozen encoders (ASR/F0/PL-BERT/Whisper) are the base init;
    # the stage-1 or resume checkpoint overwrites where present
    # (ref: train_second.py:300-326, losses.py:204-214)
    loaded = load_pretrained_encoders(cfg, nets)
    for name, src in loaded.items():
        logging.info("loaded pretrained %s from %s", name, src)

    if resume_from is None:
        # the stage-1 nets, then style_encoder -> predictor_encoder
        # (ref: train_second.py:379-399)
        first_stage = os.path.join(cfg.log_dir, cfg.first_stage_path)
        src = None
        if cfg.pretrained_model and os.path.exists(cfg.pretrained_model):
            src = cfg.pretrained_model
        elif os.path.exists(first_stage) or os.path.exists(first_stage + ".npz"):
            src = first_stage
        if src:
            logging.info("stage-2 nets from %s", src)
            if src.endswith(".pth"):
                converted = convert_reference_checkpoint(src, export_params(nets))
                load_jax_params({n: nets[n] for n in converted if n in nets}, converted)
            else:
                load_checkpoint(src, nets)
            if not cfg.second_stage_load_pretrained:
                nets["predictor_encoder"].load_state_dict(nets["style_encoder"].state_dict())

    writer = MetricsWriter(cfg.log_dir)
    try:
        return run_stage2(cfg, configs, nets, train_loader, val_loader,
                          max_steps=args.max_steps, log_cb=metrics_logger(writer, log_cb),
                          resume_from=resume_from,
                          device=device, seed=INIT_SEED, finetune=args.finetune)
    finally:
        writer.close()


if __name__ == "__main__":
    main()
