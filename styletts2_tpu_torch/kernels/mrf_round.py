"""One fused MRF round of the iSTFTNet generator: the CUDA kernel
``csrc/mrf_round.cu``, its plain PyTorch version, and the statistics that
chain one round into the next.

Port of ``styletts2_tpu/ops/pallas/mrf_round_kernel.py``.  For x (B, C_in, T)::

    u = (1 + gamma) * ((x - mean) * rstd) + beta       AdaIN with given stats
    a = u + sin(alpha * u)^2 / alpha                   Snake; 0 outside [0, T)
    y = conv1d(a, w, dilation=d, 'same') + bias [+ residual]

plus per-T-tile partials (S1, M2 around the tile mean, n) of ``y`` over the
frames ``t < lengths[b]``; ``stats_from_partials`` combines them (Chan) into
the next round's (mean, rstd).  Values in [lengths, T) are computed, not
zeroed: only the statistics are masked.

Two forms, after x's dtype: f32, and bf16 (the TPU kernel on a bf16 buffer,
``mrf_round_kernel.py:95-160``), where x, w, residual and y are bf16 while
the statistics, the AdaIN/Snake parameters and the bias stay f32.  The bf16
form computes AdaIN -> Snake in f32 and rounds it to bf16, multiplies it by
the bf16 weights with f32 sums, adds bias and residual in f32, rounds y to
bf16 and takes the partials from the rounded y.

``mrf_round`` takes a tensor on the CPU to ``mrf_round_plain`` and a CUDA
tensor to the kernel of its dtype, which runs the conv on the tensor cores
(wgmma): in 3xTF32, f32-accurate, for f32 and with C_in a multiple of 8; in
bf16 with f32 accumulators, and C_in a multiple of 16, for bf16.  C_out is a
multiple of 32 (the generators' stages have 256 down to 32 channels);
anything else raises.  ``launches`` counts kernel launches of both forms,
``bf16_launches`` those of the bf16 form.  Inference only: there is no
backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.activations import snake
from . import build

EPS = 1e-5
T_TILE = 64             # frames per tile of the partials; equals the kernel's
KERNEL_SIZES = (3, 7, 11)
MAX_PAD = 32            # the kernel's halo room: (k*d - d) // 2 <= MAX_PAD
CI_MULTIPLE, CO_MULTIPLE = 8, 32    # the kernel's chunk of C_in; C_out's step
CI_MULTIPLE_BF16 = 16               # the bf16 form's chunk of C_in: one k16 step
FORMS = (torch.float32, torch.bfloat16)   # x, w, residual and y share one of these

launches = 0
bf16_launches = 0

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("mrf_round")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.mrf_round_f32, lib.mrf_round_bf16):
            fn.argtypes = [p] * 12 + [i] * 7 + [p]
            fn.restype = i
        lib.mrf_round_t_tile.restype = i
        if lib.mrf_round_t_tile() != T_TILE:
            raise RuntimeError("csrc/mrf_round.cu tiles T by "
                               f"{lib.mrf_round_t_tile()}, not {T_TILE}")
        _LIB = lib
    return _LIB


def n_tiles(t: int) -> int:
    return -(-t // T_TILE)


def _check(x, mean, rstd, gamma, beta, alpha, w, bias, lengths, k, d, residual):
    b, c_in, t = x.shape
    c_out = w.shape[0]
    expect = {
        "x": (x, (b, c_in, t)), "mean": (mean, (b, c_in)), "rstd": (rstd, (b, c_in)),
        "gamma": (gamma, (b, c_in)), "beta": (beta, (b, c_in)),
        "alpha": (alpha, (c_in,)), "w": (w, (c_out, c_in, k)), "bias": (bias, (c_out,)),
    }
    if residual is not None:
        expect["residual"] = (residual, (b, c_out, t))
    if torch.is_grad_enabled() and any(a.requires_grad for a, _ in expect.values()):
        raise RuntimeError("mrf_round has no backward: call it under torch.no_grad()")
    if x.dtype not in FORMS:
        raise TypeError(f"mrf_round: x is {x.dtype}, needs float32 or bfloat16")
    for name, (a, shape) in expect.items():
        if a.device != x.device:
            raise ValueError(f"mrf_round: {name} on {a.device}, x on {x.device}")
        need = x.dtype if name in ("x", "w", "residual") else torch.float32
        if a.dtype != need:
            raise TypeError(f"mrf_round: {name} is {a.dtype}, needs {need} "
                            f"(x is {x.dtype})")
        if tuple(a.shape) != shape:
            raise ValueError(f"mrf_round: {name} has shape {tuple(a.shape)}, needs {shape}")
        if not a.is_contiguous():
            raise ValueError(f"mrf_round: {name} is not contiguous")
    if lengths.device != x.device or lengths.dtype != torch.int32 \
            or tuple(lengths.shape) != (b,) or not lengths.is_contiguous():
        raise ValueError("mrf_round: lengths must be a contiguous (B,) int32 "
                         "tensor on x's device")
    if k not in KERNEL_SIZES or d < 1 or (k * d - d) // 2 > MAX_PAD:
        raise ValueError(f"mrf_round: unsupported kernel size {k} / dilation {d}")
    if not 1 <= b <= 65535 or t < 1:
        raise ValueError(f"mrf_round: unsupported batch {b} or length {t}")


def mrf_round(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, alpha: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor, lengths: torch.Tensor, *,
              k: int, d: int, residual: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round.  x (B, C_in, T) f32 or bf16; mean, rstd, gamma, beta
    (B, C_in) f32; alpha (C_in,) f32; w (C_out, C_in, k) the effective
    (weight-normed) kernel in x's dtype; bias (C_out,) f32; lengths (B,)
    int32; residual (B, C_out, T) in x's dtype, or None.

    Returns y (B, C_out, T) in x's dtype and partials (B, n_tiles(T), 3,
    C_out) f32 with rows [S1, M2, n] per tile of ``T_TILE`` frames.
    """
    _check(x, mean, rstd, gamma, beta, alpha, w, bias, lengths, k, d, residual)
    if x.device.type == "cpu":
        return mrf_round_plain(x, mean, rstd, gamma, beta, alpha, w, bias,
                               lengths, k=k, d=d, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_round: no kernel for device {x.device}")
    b, c_in, t = x.shape
    c_out = w.shape[0]
    bf16 = x.dtype == torch.bfloat16
    ci_multiple = CI_MULTIPLE_BF16 if bf16 else CI_MULTIPLE
    if c_in % ci_multiple or c_out % CO_MULTIPLE:
        raise ValueError(f"mrf_round: the {x.dtype} kernel takes C_in % {ci_multiple} == 0 "
                         f"and C_out % {CO_MULTIPLE} == 0, not {c_in} -> {c_out}")
    wt = w.permute(2, 0, 1).contiguous()                       # (k, C_out, C_in)
    y = torch.empty((b, c_out, t), device=x.device, dtype=x.dtype)
    parts = torch.empty((b, n_tiles(t), 3, c_out), device=x.device, dtype=torch.float32)
    lib = _lib()
    rc = (lib.mrf_round_bf16 if bf16 else lib.mrf_round_f32)(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), alpha.data_ptr(), wt.data_ptr(), bias.data_ptr(),
        lengths.data_ptr(), None if residual is None else residual.data_ptr(),
        y.data_ptr(), parts.data_ptr(), b, c_in, c_out, t, k, d,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mrf_round kernel launch failed: cudaError_t {rc}")
    global launches, bf16_launches
    launches += 1
    bf16_launches += bf16
    return y, parts


def mrf_round_plain(x, mean, rstd, gamma, beta, alpha, w, bias, lengths, *,
                    k: int, d: int, residual=None):
    """The same round as a torch composition (any device).  For bf16 x it
    rounds where the TPU kernel does: the f32 activation to bf16, then a conv
    of the upcast bf16 operands in f32, bias and residual added in f32, y
    rounded to bf16, and the partials of the rounded y."""
    u = ((1.0 + gamma[:, :, None]) * ((x.float() - mean[:, :, None]) * rstd[:, :, None])
         + beta[:, :, None])
    a = snake(u, alpha[None, :, None]).to(x.dtype)
    y = F.conv1d(a.float(), w.float(), bias, padding=(k * d - d) // 2, dilation=d)
    if residual is not None:
        y = y + residual.float()
    y = y.to(x.dtype)
    return y, tile_partials(y.float(), lengths)


def tile_partials(y: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, n_tiles, 3, C) rows [S1, M2 around the tile mean, n]
    over the frames ``< min(lengths, T)`` of each ``T_TILE``-frame tile."""
    b, c, t = y.shape
    nt = n_tiles(t)
    yt = F.pad(y, (0, nt * T_TILE - t)).reshape(b, c, nt, T_TILE)
    pos = torch.arange(nt * T_TILE, device=y.device).reshape(nt, T_TILE)
    keep = (pos[None] < torch.clamp(lengths, max=t)[:, None, None]).to(y.dtype)
    nb = keep.sum(-1)                                          # (B, nt)
    keep = keep[:, None]                                       # (B, 1, nt, T_TILE)
    s1 = (yt * keep).sum(-1)                                   # (B, C, nt)
    mu = s1 / torch.clamp(nb, min=1.0)[:, None]
    m2 = torch.square((yt - mu[..., None]) * keep).sum(-1)
    return torch.stack([s1, m2, nb[:, None].expand_as(s1)], dim=1).permute(0, 3, 1, 2)


def stats_from_partials(parts: torch.Tensor, lengths: torch.Tensor, t: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chan's combination of tile partials -> (mean, rstd), each (B, C).

    The explicit ``(mu_b - mu)^2`` term keeps it exact where the
    difference-of-squares form cancels once the snake drifts the mean.
    """
    s1, m2, nb = parts[:, :, 0], parts[:, :, 1], parts[:, :, 2]   # (B, nt, C)
    n = torch.clamp(torch.clamp(lengths, max=t), min=1).to(parts.dtype)[:, None]
    mean = s1.sum(1) / n
    dev = s1 / torch.clamp(nb, min=1.0) - mean[:, None]
    m2_tot = m2.sum(1) + (nb * dev * dev).sum(1)
    return mean.contiguous(), torch.rsqrt(torch.clamp(m2_tot, min=0.0) / n + EPS)


def masked_stats(x: torch.Tensor, lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) (B, C) f32 of x (B, C, T) over the frames ``< lengths``:
    biased variance, eps inside the rsqrt, reduced in f32 whatever x's dtype.
    Seeds a stage's first round."""
    t = x.shape[-1]
    x = x.float()
    keep = (torch.arange(t, device=x.device)[None, :]
            < torch.clamp(lengths, max=t)[:, None]).to(x.dtype)[:, None, :]
    n = torch.clamp(keep.sum(-1), min=1.0)                     # (B, 1)
    mean = (x * keep).sum(-1) / n
    var = torch.square((x - mean[:, :, None]) * keep).sum(-1) / n
    return mean, torch.rsqrt(var + EPS)
