"""Per-epoch sample dumps of both training stages (the port of
``styletts2_tpu/train/samples.py``; ref: train_second.py:1086-1193).

For the first samples of a validation batch: the recording, its
reconstruction with the ground-truth durations and F0, and a synthesis with
the predicted durations, as 24 kHz wave files, and the monotonic alignment
as a figure (a ``.npy`` array where matplotlib is not installed), under
``<log_dir>/samples/epoch_<n>/``.
"""

from __future__ import annotations

import os
import wave as wave_mod
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..audio.mel import DATASET_MEL, log_mel_spectrogram, log_norm
from ..models.decoder import decoder_apply
from ..models.jdc import jdc_apply
from ..models.plbert import plbert_apply
from ..models.predictor import duration_encoder_apply, duration_logits, prosody_f0n_apply
from ..models.style_encoder import style_encoder_apply
from ..models.text_encoder import text_encoder_apply
from ..nn.linear import linear
from ..ops.alignment import hard_alignment
from .stage1 import HOP, compute_alignment


def write_wav(path: str, wav: np.ndarray, sr: int = 24000) -> None:
    """16-bit mono PCM of ``wav`` clipped to [-1, 1]."""
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    with wave_mod.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def write_attention_figure(path: str, attn: np.ndarray) -> None:
    """The alignment (tokens x frames) as a PNG heat map, or as ``.npy``
    beside the name when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        np.save(os.path.splitext(path)[0] + ".npy", attn)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 3))
    ax.imshow(attn, aspect="auto", origin="lower", interpolation="nearest")
    ax.set_xlabel("mel/2 frames")
    ax.set_ylabel("tokens")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


@torch.no_grad()
def generate_samples(nets: nn.ModuleDict, batch: Dict[str, torch.Tensor], out_dir: str,
                     max_samples: int = 2, frame_capacity: int = 400) -> None:
    """Write ``{i}_gt.wav``, ``{i}_rec.wav``, ``{i}_pred.wav`` and
    ``{i}_attn.png`` (or ``.npy``) for the first ``max_samples`` items of
    ``batch`` (a device batch as ``train.loop.to_device`` makes it).  The
    whole batch runs: the reconstruction through the decoder on the
    aligner's path, the pitch extractor's F0 and the energy, and the
    synthesis on ``frame_capacity`` frames of the predicted durations."""
    os.makedirs(out_dir, exist_ok=True)
    waves = batch["waves"]
    mels = log_mel_spectrogram(waves, DATASET_MEL)
    mels = mels[..., : (mels.shape[-1] // 2) * 2]
    mel_lengths = batch["mel_input_length"]
    texts, text_lengths = batch["texts"], batch["input_lengths"]

    *_, mono = compute_alignment(nets["text_aligner"], mels, mel_lengths, texts, text_lengths)
    t_en = text_encoder_apply(nets["text_encoder"], texts, text_lengths)
    s = style_encoder_apply(nets["style_encoder"], mels[:, None], mel_lengths)
    s_dur = style_encoder_apply(nets["predictor_encoder"], mels[:, None], mel_lengths)

    # the reconstruction with the ground-truth durations and F0
    f0, _, _ = jdc_apply(nets["pitch_extractor"], mels[:, None])
    y_rec = decoder_apply(nets["decoder"], t_en @ mono, f0, log_norm(mels), s)

    # the synthesis with the predicted durations
    text_keep = torch.arange(texts.shape[1], device=texts.device)[None, :] < text_lengths[:, None]
    bert_dur = plbert_apply(nets["bert"], texts, text_keep.to(torch.int32))
    be = nets["bert_encoder"]
    d_en = linear(bert_dur, be.weight, be.bias).transpose(1, 2)
    predictor = nets["predictor"]
    d = duration_encoder_apply(predictor.text_encoder, d_en, s_dur, text_lengths)
    dur = torch.sigmoid(duration_logits(predictor, d, text_lengths)).sum(-1)
    pred_dur = torch.where(text_keep, torch.clamp(torch.round(dur), min=1.0),
                           torch.zeros_like(dur)).to(torch.int32)
    aln = hard_alignment(pred_dur, frame_capacity, text_keep.float())
    f0_pred, n_pred = prosody_f0n_apply(predictor, d.transpose(1, 2) @ aln, s_dur)
    y_pred = decoder_apply(nets["decoder"], t_en @ aln, f0_pred, n_pred, s)

    waves_np, rec_np, pred_np = (x.float().cpu().numpy() for x in (waves, y_rec[:, 0],
                                                                   y_pred[:, 0]))
    frames_pred = pred_dur.sum(1).cpu().numpy()
    mono_np = mono.cpu().numpy()
    ml, tl = mel_lengths.cpu().numpy(), text_lengths.cpu().numpy()
    for i in range(min(max_samples, waves_np.shape[0])):
        n_gt = int(ml[i]) * HOP
        write_wav(os.path.join(out_dir, f"{i}_gt.wav"), waves_np[i, :n_gt])
        write_wav(os.path.join(out_dir, f"{i}_rec.wav"), rec_np[i, :n_gt])
        write_wav(os.path.join(out_dir, f"{i}_pred.wav"), pred_np[i, : int(frames_pred[i]) * 2 * HOP])
        write_attention_figure(os.path.join(out_dir, f"{i}_attn.png"),
                               mono_np[i, : int(tl[i]), : int(ml[i]) // 2])
