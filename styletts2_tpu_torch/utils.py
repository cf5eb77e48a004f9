"""Utilities (the port of the parts of ``styletts2_tpu/utils.py`` the
trainers and the demo use): the scalar metrics log and the real-time
factor."""

from __future__ import annotations

import json
import os
from typing import Dict


class MetricsWriter:
    """Scalar logger: ``metrics.jsonl`` in ``log_dir`` always, TensorBoard
    too when ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # needs tensorboard

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalars(self, step: int, scalars: Dict[str, float], prefix: str = "train"):
        rec = {"step": step, **{f"{prefix}/{k}": float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def rtf(elapsed_s: float, wave_samples: int, sr: int = 24000) -> float:
    """Real-time factor as printed by the demo notebooks
    (Demo/Inference_LJSpeech.ipynb cell 19): elapsed / audio_seconds."""
    return elapsed_s / (wave_samples / sr)
