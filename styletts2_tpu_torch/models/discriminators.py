"""The GAN discriminators (ref: Modules/discriminators.py): the
multi-period discriminator (MPD) and the multi-resolution spectrogram
discriminator (MSD), with their feature maps for the feature-matching loss,
and stage 2's Whisper discriminator head (WD) over the stacked SLM features.

Every conv is weight-normed.  The MPD's period towers fold the period into
the batch and run as conv1d: each kernel is (K, 1) and never mixes the
period's columns, so this is the reference's Conv2d over (T/p, p) exactly;
the weights keep their 4-D checkpoint shape, and the feature maps come back
in the reference's (B, C, T/p, p) layout.  The MSD runs the plain NCHW
tower; the JAX package's bin-packed form (``_packed_conv``) is a TPU layout
with no counterpart here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.activations import leaky_relu
from ..nn.conv import conv1d, conv2d
from . import common as cm
from .common import WeightNormed

LRELU_SLOPE = 0.1
PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = (32, 128, 512, 1024, 1024)
SPEC_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))

Outputs = Tuple[List[torch.Tensor], List[torch.Tensor], List[List[torch.Tensor]],
                List[List[torch.Tensor]]]


def _wn_conv2d(in_ch: int, out_ch: int, kernel: Tuple[int, int]) -> WeightNormed:
    return WeightNormed((out_ch, in_ch, *kernel), out_ch)


class _PeriodTower(nn.Module):
    def __init__(self, channels: Sequence[int]):
        super().__init__()
        chans = list(zip((1,) + tuple(channels[:-1]), channels))
        self.convs = nn.ModuleList(_wn_conv2d(ci, co, (5, 1)) for ci, co in chans)
        self.conv_post = _wn_conv2d(channels[-1], 1, (3, 1))


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, channels: Sequence[int] = MPD_CHANNELS):
        super().__init__()
        self.discriminators = nn.ModuleList(_PeriodTower(channels) for _ in PERIODS)


class _SpecTower(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [_wn_conv2d(1, width, (3, 9))] + [_wn_conv2d(width, width, (3, 9)) for _ in range(3)]
            + [_wn_conv2d(width, width, (3, 3))])
        self.out = _wn_conv2d(width, 1, (3, 3))


class MultiResSpecDiscriminator(nn.Module):
    def __init__(self, width: int = 32):
        super().__init__()
        self.discriminators = nn.ModuleList(_SpecTower(width) for _ in SPEC_RESOLUTIONS)


def _period_tower(p: _PeriodTower, x: torch.Tensor, period: int
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x (B, 1, T) -> (scores (B, H·p), fmaps (B, C, H, p) each)."""
    b, c, t = x.shape
    if t % period:
        x = F.pad(x, (0, period - t % period), mode="reflect")
        t = x.shape[-1]
    h = t // period
    x = x.reshape(b, c, h, period).permute(0, 3, 1, 2).reshape(b * period, c, h)

    def unfold(y):
        return y.reshape(b, period, y.shape[1], y.shape[2]).permute(0, 2, 3, 1)

    fmap = []
    for j, conv in enumerate(p.convs):
        x = conv1d(x, conv.weight()[..., 0], conv.bias, stride=3 if j < 4 else 1, padding=2)
        x = leaky_relu(x, LRELU_SLOPE)
        fmap.append(unfold(x))
    x = conv1d(x, p.conv_post.weight()[..., 0], p.conv_post.bias, padding=1)
    fmap.append(unfold(x))
    return unfold(x).reshape(b, -1), fmap


def _spec_tower(p: _SpecTower, x: torch.Tensor, res: Tuple[int, int, int]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x (B, 1, T) -> (scores (B, frames·bins), fmaps (B, C, frames, bins))."""
    n_fft, hop, win = res
    window = torch.hann_window(win, periodic=True, dtype=torch.float32, device=x.device)
    mag = torch.stft(x[:, 0, :].float(), n_fft, hop, win, window=window, center=True,
                     pad_mode="reflect", return_complex=True).abs()
    # The JAX package drops the Nyquist bin (a TPU lane layout choice,
    # styletts2_tpu/models/discriminators.py:140); the reference keeps it.
    # The JAX package is the port's oracle, so it goes here too: the MSD's
    # scores and feature maps differ from the reference's.
    mag = mag[:, :-1, :]
    y = mag.transpose(1, 2)[:, None].to(x.dtype)               # (B, 1, frames, bins)
    fmap = []
    for j, conv in enumerate(p.discriminators):
        y = conv2d(y, conv.weight(), conv.bias, stride=(1, 2) if 0 < j < 4 else (1, 1),
                   padding=(1, 4) if j < 4 else (1, 1))
        y = leaky_relu(y, LRELU_SLOPE)
        fmap.append(y)
    y = conv2d(y, p.out.weight(), p.out.bias, padding=(1, 1))
    fmap.append(y)
    return y.reshape(y.shape[0], -1), fmap


def mpd_towers(m: MultiPeriodDiscriminator, y: torch.Tensor):
    """Every period tower on one batch y (B, 1, T): (scores, fmaps) lists."""
    outs = [_period_tower(t, y, p) for t, p in zip(m.discriminators, PERIODS)]
    return [s for s, _ in outs], [f for _, f in outs]


def msd_towers(m: MultiResSpecDiscriminator, y: torch.Tensor):
    """Every resolution's tower on one batch y (B, 1, T): (scores, fmaps)."""
    outs = [_spec_tower(t, y, r) for t, r in zip(m.discriminators, SPEC_RESOLUTIONS)]
    return [s for s, _ in outs], [f for _, f in outs]


def _apply(towers, m, y: torch.Tensor, y_hat: torch.Tensor, batched: bool) -> Outputs:
    if batched:
        b = y.shape[0]
        scores, fmaps = towers(m, torch.cat([y, y_hat], dim=0))
        return ([s[:b] for s in scores], [s[b:] for s in scores],
                [[f[:b] for f in fm] for fm in fmaps], [[f[b:] for f in fm] for fm in fmaps])
    real_s, real_f = towers(m, y)
    fake_s, fake_f = towers(m, y_hat)
    return real_s, fake_s, real_f, fake_f


def mpd_apply(m: MultiPeriodDiscriminator, y: torch.Tensor, y_hat: torch.Tensor,
              batched: bool = True) -> Outputs:
    """(real scores, fake scores, real fmaps, fake fmaps) for y, y_hat (B, 1,
    T).  ``batched`` runs both through each tower as one 2B pass (the
    discriminator step); otherwise one pass each (the generator side, where
    only the fake branch needs a graph)."""
    return _apply(mpd_towers, m, y, y_hat, batched)


def msd_apply(m: MultiResSpecDiscriminator, y: torch.Tensor, y_hat: torch.Tensor,
              batched: bool = True) -> Outputs:
    """As ``mpd_apply``, for the spectrogram towers."""
    return _apply(msd_towers, m, y, y_hat, batched)


class WhisperDiscriminator(nn.Module):
    """The SLM discriminator head: a 1x1 conv from the stacked Whisper states
    (``slm_hidden * slm_layers`` channels), three k=5 convs to 4x
    ``initial_channel`` and a k=3 score conv, all weight-normed."""

    def __init__(self, slm_hidden: int = 512, slm_layers: int = 7, initial_channel: int = 64):
        super().__init__()
        c = initial_channel
        self.pre = cm.WNConv1d(slm_hidden * slm_layers, c, 1)
        self.convs = nn.ModuleList([cm.WNConv1d(c, c * 2, 5), cm.WNConv1d(c * 2, c * 4, 5),
                                    cm.WNConv1d(c * 4, c * 4, 5)])
        self.conv_post = cm.WNConv1d(c * 4, 1, 3)


def whisper_discriminator_apply(m: WhisperDiscriminator, x: torch.Tensor) -> torch.Tensor:
    """x (B, slm_hidden * slm_layers, T) stacked SLM features -> scores (B, T)."""
    x = cm.wn_conv1d(m.pre, x)
    for conv in m.convs:
        x = leaky_relu(cm.wn_conv1d(conv, x, padding=2), LRELU_SLOPE)
    x = cm.wn_conv1d(m.conv_post, x, padding=1)
    return x.reshape(x.shape[0], -1)
