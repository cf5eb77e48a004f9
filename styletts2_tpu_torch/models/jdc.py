"""JDC pitch extractor (ref: Utils/JDC/model.py).

CRNN over mel spectrograms: a conv stem, three frequency-pooling residual
blocks, a pool block, BiLSTM sequence models, a per-frame F0 regression
(``classifier``) and a voicing detector.  Training reads
``abs(classifier_out)`` as the F0 curve (ref: train_first.py:41-88).
BatchNorms run in eval form from the stored running statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..nn.activations import leaky_relu
from ..nn.conv import conv2d
from ..nn.linear import linear
from ..nn.lstm import bilstm


@dataclasses.dataclass(frozen=True)
class JDCConfig:
    num_class: int = 1
    mel_bins: int = 80
    leaky_slope: float = 0.01
    lstm_hidden: int = 384
    lstm_layers: int = 2


class BatchNormStats(nn.Module):
    """Exactly the four tensors of the JAX tree (no ``num_batches_tracked``):
    ``weight``/``bias`` parameters, ``running_mean``/``running_var`` buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


def _bn(m: BatchNormStats, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - m.running_mean.reshape(shape)) / torch.sqrt(m.running_var.reshape(shape) + eps)
            * m.weight.reshape(shape) + m.bias.reshape(shape))


def _conv(i: int, o: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(i, o, k, bias=False)


class _ResBlock(nn.Module):
    def __init__(self, i: int, o: int):
        super().__init__()
        self.pre_conv = nn.ModuleDict({"0": BatchNormStats(i)})
        self.conv = nn.ModuleDict({"0": _conv(i, o, 3), "1": BatchNormStats(o),
                                   "3": _conv(o, o, 3)})
        self.conv1by1 = _conv(i, o, 1)


def _seq_lstm(i: int, hidden: int, layers: int) -> nn.ModuleDict:
    return nn.ModuleDict({"model": nn.LSTM(i, hidden, num_layers=layers, batch_first=True,
                                           bidirectional=True)})


class JDC(nn.Module):
    def __init__(self, cfg: JDCConfig = JDCConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv_block = nn.ModuleDict({"0": _conv(1, 64, 3), "1": BatchNormStats(64),
                                         "3": _conv(64, 64, 3)})
        self.res_block1 = _ResBlock(64, 128)
        self.res_block2 = _ResBlock(128, 192)
        self.res_block3 = _ResBlock(192, 256)
        self.pool_block = nn.ModuleDict({"0": BatchNormStats(256)})
        self.detector_conv = nn.ModuleDict({"0": _conv(640, 256, 1), "1": BatchNormStats(256)})
        self.sequence_classifier = _seq_lstm(512, cfg.lstm_hidden, cfg.lstm_layers)
        self.sequence_detector = _seq_lstm(512, cfg.lstm_hidden, cfg.lstm_layers)
        self.classifier = nn.Linear(cfg.lstm_hidden * 2, cfg.num_class)
        self.detector = nn.Linear(cfg.lstm_hidden * 2, 2)


def _maxpool_freq(x: torch.Tensor, k: int) -> torch.Tensor:
    """MaxPool2d(kernel=(1, k)) over the trailing (frequency) axis."""
    t = x.shape[-1] - x.shape[-1] % k
    return x[..., :t].reshape(*x.shape[:-1], t // k, k).amax(dim=-1)


def _res_block(m: _ResBlock, x: torch.Tensor, slope: float) -> torch.Tensor:
    h = leaky_relu(_bn(m.pre_conv["0"], x), slope)
    h = _maxpool_freq(h, 2)
    y = conv2d(h, m.conv["0"].weight, padding=1)
    y = leaky_relu(_bn(m.conv["1"], y), slope)
    y = conv2d(y, m.conv["3"].weight, padding=1)
    return y + conv2d(h, m.conv1by1.weight)


def jdc_apply(m: JDC, mels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mels (B, 80, T) or (B, 1, 80, T) normalized log-mel -> (f0 (B, T),
    voicing (B, T), pool features (B, 256, T, 2))."""
    cfg = m.cfg
    x = mels if mels.ndim == 4 else mels[:, None]
    if x.shape[-1] != cfg.mel_bins and x.shape[-2] == cfg.mel_bins:
        x = x.transpose(-1, -2)                                # (B, 1, T, mel)
    slope = cfg.leaky_slope
    cb = m.conv_block
    h = leaky_relu(_bn(cb["1"], conv2d(x, cb["0"].weight, padding=1)), slope)
    conv_out = conv2d(h, cb["3"].weight, padding=1)           # (B, 64, T, 80)
    r1 = _res_block(m.res_block1, conv_out, slope)             # (B, 128, T, 40)
    r2 = _res_block(m.res_block2, r1, slope)                   # (B, 192, T, 20)
    r3 = _res_block(m.res_block3, r2, slope)                   # (B, 256, T, 10)
    pool = _maxpool_freq(leaky_relu(_bn(m.pool_block["0"], r3), slope), 4)  # (B, 256, T, 2)

    b, c, t, f = pool.shape
    cls_in = pool.permute(0, 2, 1, 3).reshape(b, t, c * f)
    cls = bilstm(m.sequence_classifier["model"], cls_in)
    cls = linear(cls, m.classifier.weight, m.classifier.bias)

    det = torch.cat([_maxpool_freq(conv_out, 40), _maxpool_freq(r1, 20),
                     _maxpool_freq(r2, 10), pool], dim=1)      # (B, 640, T, 2)
    dc = m.detector_conv
    det = leaky_relu(_bn(dc["1"], conv2d(det, dc["0"].weight)), slope)
    det_h = bilstm(m.sequence_detector["model"], det.permute(0, 2, 1, 3).reshape(b, t, 512))
    voicing = linear(det_h, m.detector.weight, m.detector.bias).sum(-1)
    f0 = torch.abs(cls[..., 0] if cfg.num_class == 1 else cls.squeeze(-1))
    return f0, voicing, pool
