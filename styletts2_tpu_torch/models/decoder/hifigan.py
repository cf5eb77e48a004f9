"""HiFi-GAN decoder — the LibriTTS/multispeaker vocoder
(ref: Modules/hifigan.py:271-474).

Its AdainResBlk1d encode/decode head, harmonic source and MRF stages are the
iSTFTNet decoder's (``istftnet.decoder_head``, ``source_branch``,
``mrf_stage``).  The generator instead upsamples all the way to the
waveform with four transposed-conv stages, with per-stage Snake ``alphas``,
the raw mel-rate harmonic source injected through ``noise_convs`` (no
STFT), and a tanh output.

``fused=True`` (the inference engine's path) runs ``noise_res`` and every
MRF resblock through the fused round (``kernels/mrf_round.py``, K2 on the
card) at each stage's width, 256 down to 32 channels at LibriTTS width.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ...config import DecoderConfig
from ...nn.activations import snake
from ...nn.conv import conv_transpose1d
from .. import common as cm
from . import istftnet
from .resblock import AdainResBlock1
from .source import SourceModule, source_module_apply_mel


class Generator(nn.Module):
    def __init__(self, cfg: DecoderConfig, style_dim: int = 128):
        super().__init__()
        self.cfg = cfg
        rates, init_ch = cfg.upsample_rates, cfg.upsample_initial_channel
        self.m_source = SourceModule()
        alphas = [nn.Parameter(torch.ones(1, init_ch, 1))]
        ups, noise_convs, noise_res, resblocks = [], [], [], []
        for i, (u, k) in enumerate(zip(rates, cfg.upsample_kernel_sizes)):
            c_cur = init_ch // (2 ** (i + 1))
            ups.append(cm.WNConvTranspose1d(init_ch // (2 ** i), c_cur, k))
            if i + 1 < len(rates):
                noise_convs.append(nn.Conv1d(1, c_cur, math.prod(rates[i + 1:]) * 2))
                noise_res.append(AdainResBlock1(c_cur, 7, (1, 3, 5), style_dim))
            else:
                noise_convs.append(nn.Conv1d(1, c_cur, 1))
                noise_res.append(AdainResBlock1(c_cur, 11, (1, 3, 5), style_dim))
            alphas.append(nn.Parameter(torch.ones(1, c_cur, 1)))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                resblocks.append(AdainResBlock1(c_cur, rk, rd, style_dim))
        self.alphas = nn.ParameterList(alphas)
        self.ups = nn.ModuleList(ups)
        self.noise_convs = nn.ModuleList(noise_convs)
        self.noise_res = nn.ModuleList(noise_res)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = cm.WNConv1d(init_ch // (2 ** len(rates)), 1, 7)

    @property
    def samples_per_frame(self) -> int:
        """Waveform samples per input frame: the upsampling alone."""
        return math.prod(self.cfg.upsample_rates)


def generator_apply(m: Generator, x: torch.Tensor, s: torch.Tensor, f0: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None, fused: bool = False,
                    source_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, init_ch, T_mel), s (B, S), f0 (B, T_mel) -> waveform (B, 1, T_samples)
    (ref: Modules/hifigan.py:320-346).  ``lengths`` (B,) valid frames at
    T_mel; ``source_noise`` the harmonic source's dither (None: zero)."""
    rates = m.cfg.upsample_rates
    # the sine bank is a constant; its merge layer trains, as in the
    # reference (Modules/hifigan.py wraps only l_sin_gen in no_grad)
    har = source_module_apply_mel(m.m_source, f0, math.prod(rates),
                                  noise=source_noise).transpose(1, 2).to(x.dtype)
    for i, u in enumerate(rates):
        x = snake(x, m.alphas[i])
        stage_lengths = None if lengths is None else lengths * math.prod(rates[: i + 1])
        x_source = istftnet.source_branch(m, har, s, i, stage_lengths, fused)
        up = m.ups[i]
        # odd rates (5, 3) take an output padding: each stage is exactly u x
        x = conv_transpose1d(x, up.weight(), up.bias, stride=u, padding=u // 2 + u % 2,
                             output_padding=u % 2)
        x = istftnet.mrf_stage(m, x + istftnet.fit_length(x_source, x.shape[-1]), s, i,
                               stage_lengths, fused)
    x = snake(x, m.alphas[len(rates)])
    return torch.tanh(cm.wn_conv1d(m.conv_post, x, padding=3))


class Decoder(istftnet.Decoder):
    """The iSTFTNet decoder's head over the HiFi-GAN generator."""

    generator_cls = Generator


def decoder_apply(m: Decoder, asr: torch.Tensor, f0_curve: torch.Tensor,
                  n_curve: torch.Tensor, s: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None, fused: bool = False,
                  source_noise: Optional[torch.Tensor] = None,
                  smooth: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``istftnet.decoder_head`` then the HiFi-GAN generator -> waveform
    (B, 1, T_samples) (ref: Modules/hifigan.py:445-474).  The training form
    passes ``smooth``, the indices of the F0 and energy curves' smoothing
    widths (``istftnet.random_smooth``), and the dither ``source_noise``;
    it runs ``fused=False``, whose AdaIN -> Snake pairs go through
    ``ops/fused.py::adain_snake`` (K1f forward, K1b backward on the card)."""
    x, s, f0_curve = istftnet.decoder_head(m, asr, f0_curve, n_curve, s, lengths, fused,
                                           smooth)
    return generator_apply(m.generator, x, s, f0_curve,
                           lengths=None if lengths is None else lengths * 2,
                           fused=fused, source_noise=source_noise)
