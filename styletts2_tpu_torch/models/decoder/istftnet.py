"""iSTFTNet decoder — the LJSpeech vocoder (ref: Modules/istftnet.py:301-527).

``Decoder``: an AdainResBlk1d encode/decode stack over concat(aligned text
features, downsampled F0/N curves), then ``Generator``: the harmonic source
(its STFT injected at every scale), transposed-conv upsampling stages with
Snake MRF resblocks, and a magnitude/phase head inverted with the iSTFT.

``fused=True`` (the inference engine's path) runs every MRF resblock through
the fused round (``kernels/mrf_round.py``): one statistics reduction per
stage, shared by its resblocks, and chained statistics inside each.  The
plain path, which training takes, runs each AdaIN -> Snake pair through
``ops/fused.py::adain_snake`` (the K1 kernels on the card); the fused round
has no backward.  In training the F0 and energy curves are smoothed by a
moving average of a randomly chosen width (``random_smooth``), chosen here
by explicit indices.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ...audio.stft import istft_from_mag_phase, stft_mag_phase
from ...config import DecoderConfig
from ...kernels.mrf_round import masked_stats
from ...nn.activations import leaky_relu
from ...nn.conv import conv1d, conv_transpose1d
from .. import common as cm
from ..adain_blocks import AdainResBlk1d, adain_resblk1d_apply
from .resblock import AdainResBlock1, adain_resblock1_apply, adain_resblock1_fused
from .source import SourceModule, source_module_apply_mel


class Generator(nn.Module):
    def __init__(self, cfg: DecoderConfig, style_dim: int = 128):
        super().__init__()
        self.cfg = cfg
        rates, init_ch = cfg.upsample_rates, cfg.upsample_initial_channel
        n_fft = cfg.gen_istft_n_fft
        self.m_source = SourceModule()
        ups, noise_convs, noise_res, resblocks = [], [], [], []
        for i, (u, k) in enumerate(zip(rates, cfg.upsample_kernel_sizes)):
            c_cur = init_ch // (2 ** (i + 1))
            ups.append(cm.WNConvTranspose1d(init_ch // (2 ** i), c_cur, k))
            if i + 1 < len(rates):
                noise_convs.append(nn.Conv1d(n_fft + 2, c_cur, math.prod(rates[i + 1:]) * 2))
                noise_res.append(AdainResBlock1(c_cur, 7, (1, 3, 5), style_dim))
            else:
                noise_convs.append(nn.Conv1d(n_fft + 2, c_cur, 1))
                noise_res.append(AdainResBlock1(c_cur, 11, (1, 3, 5), style_dim))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                resblocks.append(AdainResBlock1(c_cur, rk, rd, style_dim))
        self.ups = nn.ModuleList(ups)
        self.noise_convs = nn.ModuleList(noise_convs)
        self.noise_res = nn.ModuleList(noise_res)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = cm.WNConv1d(init_ch // (2 ** len(rates)), n_fft + 2, 7)

    @property
    def samples_per_frame(self) -> int:
        """Waveform samples per input frame: the upsampling and the iSTFT hop."""
        return math.prod(self.cfg.upsample_rates) * self.cfg.gen_istft_hop_size


def fit_length(x: torch.Tensor, t: int) -> torch.Tensor:
    """x cropped or zero-padded to ``t`` frames (the source branch against
    the upsampled signal's, possibly off-by-one, length)."""
    x = x[..., :t]
    return nn.functional.pad(x, (0, t - x.shape[-1])) if x.shape[-1] < t else x


def _stage_lengths(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    b, _, t = x.shape
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int32, device=x.device)
    return torch.clamp(lengths, max=t).to(torch.int32)


def mrf_stage(m: nn.Module, x, s, stage: int, lengths, fused: bool) -> torch.Tensor:
    """The mean of stage ``stage``'s MRF resblocks (``m.resblocks``) over x.
    Fused: through the fused round, one stats reduction shared by the
    stage's resblocks and chained stats inside each."""
    nk = len(m.cfg.resblock_kernel_sizes)
    blocks = m.resblocks[stage * nk:(stage + 1) * nk]
    if fused:
        lens = _stage_lengths(x, lengths)
        stats = masked_stats(x, lens)
    xs = None
    for blk in blocks:
        r = (adain_resblock1_fused(blk, x, s, lens, stats=stats)[0] if fused
             else adain_resblock1_apply(blk, x, s, lengths))
        xs = r if xs is None else xs + r
    return xs / nk


def source_branch(m: nn.Module, har: torch.Tensor, s: torch.Tensor, stage: int,
                  lengths, fused: bool) -> torch.Tensor:
    """Stage ``stage``'s harmonic-source branch: ``m.noise_convs`` (strided to
    the stage's rate, kernel 1 at the last stage), then ``m.noise_res``."""
    rates = m.cfg.upsample_rates
    nc = m.noise_convs[stage]
    if stage + 1 < len(rates):
        stride_f0 = math.prod(rates[stage + 1:])
        x_source = conv1d(har, nc.weight, nc.bias, stride=stride_f0,
                          padding=(stride_f0 + 1) // 2)
    else:
        x_source = conv1d(har, nc.weight, nc.bias)
    if fused:
        return adain_resblock1_fused(m.noise_res[stage], x_source, s,
                                     _stage_lengths(x_source, lengths))[0]
    return adain_resblock1_apply(m.noise_res[stage], x_source, s, lengths)


def generator_apply(m: Generator, x: torch.Tensor, s: torch.Tensor, f0: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None, fused: bool = False,
                    source_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, init_ch, T_mel), s (B, S), f0 (B, T_mel) -> waveform (B, 1, T_samples)
    (ref: Modules/istftnet.py:349-379).  ``lengths`` (B,) valid frames at
    T_mel; ``source_noise`` the harmonic source's dither (None: zero)."""
    cfg = m.cfg
    rates = cfg.upsample_rates
    n_fft, hop = cfg.gen_istft_n_fft, cfg.gen_istft_hop_size

    # the harmonic source is a constant, as in the reference (no_grad)
    har = source_module_apply_mel(m.m_source, f0, math.prod(rates) * hop,
                                  noise=source_noise)[..., 0].detach()
    har_spec, har_phase = stft_mag_phase(har, n_fft, hop, n_fft)
    har = torch.cat([har_spec, har_phase], dim=1).to(x.dtype)

    for i in range(len(rates)):
        x = leaky_relu(x, 0.1)
        stage_lengths = None if lengths is None else lengths * math.prod(rates[: i + 1])
        x_source = source_branch(m, har, s, i, stage_lengths, fused)
        up = m.ups[i]
        u, k = rates[i], cfg.upsample_kernel_sizes[i]
        x = conv_transpose1d(x, up.weight(), up.bias, stride=u, padding=(k - u) // 2)
        if i == len(rates) - 1:
            x = torch.cat([x[..., 1:2], x], dim=-1)            # reflection pad (1, 0)
        x = mrf_stage(m, x + fit_length(x_source, x.shape[-1]), s, i, stage_lengths, fused)

    x = leaky_relu(x, 0.01)
    x = cm.wn_conv1d(m.conv_post, x, padding=3)
    spec = torch.exp(x[:, : n_fft // 2 + 1, :])
    phase = torch.sin(x[:, n_fft // 2 + 1:, :])
    return istft_from_mag_phase(spec, phase, n_fft, hop, n_fft)[:, None, :]


class Decoder(nn.Module):
    """``width``/``asr_res_ch`` default to the reference's 1024/64 channel
    plan; smaller values are for tests.  The AdainResBlk1d head is the
    HiFi-GAN decoder's too (``hifigan.Decoder`` sets ``generator_cls``)."""

    generator_cls = Generator

    def __init__(self, cfg: DecoderConfig, dim_in: int = 512, style_dim: int = 128,
                 width: int = 1024, asr_res_ch: int = 64):
        super().__init__()
        self.encode = AdainResBlk1d(dim_in + 2, width, style_dim)
        mid = width + 2 + asr_res_ch
        self.decode = nn.ModuleList([
            AdainResBlk1d(mid, width, style_dim), AdainResBlk1d(mid, width, style_dim),
            AdainResBlk1d(mid, width, style_dim),
            AdainResBlk1d(mid, width // 2, style_dim, upsample=True)])
        self.F0_conv = cm.WNConv1d(1, 1, 3)
        self.N_conv = cm.WNConv1d(1, 1, 3)
        self.asr_res = nn.ModuleList([cm.WNConv1d(dim_in, asr_res_ch, 1)])
        self.generator = self.generator_cls(cfg, style_dim)


F0_SMOOTH = (0, 3, 7)
N_SMOOTH = (0, 3, 7, 15)


def random_smooth(curve: torch.Tensor, index: torch.Tensor,
                  down_choices: Sequence[int]) -> torch.Tensor:
    """Moving average of width ``down_choices[index]`` (0: none) over the
    curve (B, T) (ref: Modules/istftnet.py:499-507); ``index`` a 0-dim
    integer tensor, chosen among the stacked candidates on the device."""
    outs = []
    for d in down_choices:
        if d == 0:
            outs.append(curve)
        else:
            kern = torch.full((1, 1, d), 1.0 / d, dtype=curve.dtype, device=curve.device)
            outs.append(conv1d(curve[:, None, :], kern, padding=d // 2)[:, 0, : curve.shape[-1]])
    return torch.stack(outs)[index]


def decoder_head(m: Decoder, asr: torch.Tensor, f0_curve: torch.Tensor,
                 n_curve: torch.Tensor, s: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None, fused: bool = False,
                 smooth: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The AdainResBlk1d encode/decode stack of both decoders
    (ref: Modules/istftnet.py:498-524, Modules/hifigan.py:445-471): asr
    (B, C, T_en) aligned text features, f0/n curves (B, 2*T_en), s (B, S),
    lengths (B,) valid T_en frames -> (the generator's input (B, width/2,
    2*T_en), s, the F0 curve), cast to the decoder's dtype.  ``smooth``
    (training): the indices into ``F0_SMOOTH`` and ``N_SMOOTH`` of the
    curves' smoothing widths."""
    asr, f0_curve, n_curve, s = cm.autocast(m, asr, f0_curve, n_curve, s)
    if smooth is not None:
        if fused:
            raise ValueError("the fused decoder has no backward: training runs fused=False")
        f0_curve = random_smooth(f0_curve, smooth[0], F0_SMOOTH)
        n_curve = random_smooth(n_curve, smooth[1], N_SMOOTH)
    f0 = cm.wn_conv1d(m.F0_conv, f0_curve[:, None, :], stride=2, padding=1)
    n = cm.wn_conv1d(m.N_conv, n_curve[:, None, :], stride=2, padding=1)

    x = adain_resblk1d_apply(m.encode, torch.cat([asr, f0, n], dim=1), s, lengths)
    asr_res = cm.wn_conv1d(m.asr_res[0], asr)
    res = True
    for blk in m.decode:
        if res:
            x = torch.cat([x, asr_res, f0, n], dim=1)
        x = adain_resblk1d_apply(blk, x, s, lengths)
        if blk.upsample:
            res = False
    return x, s, f0_curve


def decoder_apply(m: Decoder, asr: torch.Tensor, f0_curve: torch.Tensor,
                  n_curve: torch.Tensor, s: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None, fused: bool = False,
                  source_noise: Optional[torch.Tensor] = None,
                  smooth: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``decoder_head`` then the iSTFTNet generator -> waveform
    (B, 1, T_samples) (ref: Modules/istftnet.py:498-527)."""
    x, s, f0_curve = decoder_head(m, asr, f0_curve, n_curve, s, lengths, fused, smooth)
    return generator_apply(m.generator, x, s, f0_curve,
                           lengths=None if lengths is None else lengths * 2,
                           fused=fused, source_noise=source_noise)
