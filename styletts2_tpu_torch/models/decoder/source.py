"""Harmonic source of the iSTFTNet generator (ref: Modules/istftnet.py:111-296),
fed with the mel-rate F0 curve.

The reference repeats F0 to audio rate only to decimate it straight back, so
the decimated instantaneous frequency equals ``(f0*h/fs) % 1`` computed at mel
rate (exact for an upsample scale >= 3; see the JAX ``_sine_gen_mel_cf``).
The phase is integrated at mel rate in *turns*, linearly re-interpolated to
audio rate with static per-phase fractions, reduced in turns, and only then
multiplied by 2*pi.  ``SourceModuleHnNSF`` merges the nine harmonics through
tanh(linear).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...nn.activations import sin_turns


class SourceModule(nn.Module):
    def __init__(self, harmonic_num: int = 8):
        super().__init__()
        self.l_linear = nn.Linear(harmonic_num + 1, 1)


def _upsample_linear_int(x: torch.Tensor, u: int) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=u, mode='linear')`` for integer ``u``:
    output ``j = u*t + r`` mixes a fixed neighbour pair with the static
    fraction of phase ``r`` (computed in double, as torch's source indices)."""
    o = (np.arange(u) + 0.5) / u - 0.5
    frac = torch.as_tensor(np.where(o < 0, 1.0 + o, o).astype(np.float32),
                           device=x.device)
    neg = torch.as_tensor(o < 0, device=x.device)
    xm1 = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    xp1 = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    xl = torch.where(neg, xm1[..., None], x[..., None])        # (..., T, u)
    xh = torch.where(neg, x[..., None], xp1[..., None])
    out = xl + (xh - xl) * frac
    return out.reshape(*x.shape[:-1], x.shape[-1] * u)


def source_module_apply_mel(m: SourceModule, f0_mel: torch.Tensor,
                            upsample_scale: int, sampling_rate: int = 24000,
                            sine_amp: float = 0.1, noise_std: float = 0.003,
                            voiced_threshold: float = 10.0,
                            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f0_mel (B, T_mel) -> merged harmonic source (B, T_mel*upsample_scale, 1).

    ``noise`` (B, harmonics, T_audio) standard normals is SineGen's dither;
    None gives the deterministic zero-dither source the engine uses.
    """
    if upsample_scale < 3:
        raise ValueError("the mel-rate sine bank is exact only for upsample_scale >= 3")
    f0_mel = f0_mel.float()
    dim = m.l_linear.weight.shape[1]
    harmonics = torch.arange(1, dim + 1, dtype=torch.float32, device=f0_mel.device)
    rad_lo = (f0_mel[:, None, :] * harmonics[None, :, None] / sampling_rate) % 1.0
    turns_lo = torch.cumsum(rad_lo, dim=-1)                     # (B, dim, T_mel)
    turns = _upsample_linear_int(turns_lo * upsample_scale, upsample_scale)
    sine_waves = sin_turns(turns) * sine_amp                    # (B, dim, T_audio)

    uv_lo = (f0_mel > voiced_threshold).float()
    uv = torch.repeat_interleave(uv_lo[:, None, :], upsample_scale, dim=-1)
    sine_waves = sine_waves * uv
    if noise is not None:
        noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
        sine_waves = sine_waves + noise_amp * noise
    # the sine bank is a constant (the reference runs it under no_grad): only
    # the merge ``l_linear`` takes a gradient
    sine_waves = sine_waves.detach()
    w = m.l_linear.weight.reshape(-1).float()
    merged = (torch.sum(sine_waves * w[None, :, None], dim=1, keepdim=True)
              + m.l_linear.bias.float()[None, :, None])
    return torch.tanh(merged).transpose(1, 2)
