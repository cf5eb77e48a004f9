"""AdaIN -> Snake on (B, C, T), forward and backward: the CUDA kernels of
``csrc/adain_snake.cu``, their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Port of ``styletts2_tpu/ops/pallas/adain_snake_kernel.py`` (``_fwd_call``
and the custom VJP's ``_bwd_call``).  For x (B, C, T), the statistics over
the frames ``t < lengths[b]`` (all T when ``lengths`` is None)::

    xh = (x - mean) * rstd          mean, centred variance, eps 1e-5
    u  = (1 + gamma) * xh + beta     gamma, beta (B, C)
    y  = u + sin(alpha * u)^2 / alpha

Every frame gets an output and a gradient; only the statistics are masked.

``adain_snake`` takes a tensor on the CPU to ``adain_snake_plain``
(differentiated by autograd) and a CUDA tensor to the kernels inside
``AdainSnake``, whose backward is the K1b kernel; anything else raises.
``fwd_launches`` and ``bwd_launches`` count kernel launches; ``plan`` names
the path a row length takes on the card (the kernel picks it from T).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..nn.activations import snake
from . import build
from .mrf_round import masked_stats

fwd_launches = 0
bwd_launches = 0

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("adain_snake")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.adain_snake_fwd_f32.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.adain_snake_fwd_f32.restype = i
        lib.adain_snake_bwd_f32.argtypes = [p] * 12 + [i] * 4 + [p]
        lib.adain_snake_bwd_f32.restype = i
        lib.adain_snake_plan.argtypes = [i] * 3 + [p] * 3
        lib.adain_snake_plan.restype = i
        _LIB = lib
    return _LIB


def _check(x, lengths, rows=()):
    """x (B, C, T); ``rows`` holds (name, tensor, shape) triples; all f32,
    contiguous and on x's device; lengths None or (B,) int32.  One
    combined test a tensor on the common path; ``_reject`` says what is
    wrong."""
    if x.dim() != 3:
        raise ValueError(f"adain_snake: x has shape {tuple(x.shape)}, needs (B, C, T)")
    dev = x.device
    for name, a, shape in (("x", x, x.shape), *rows):
        if not (a.dtype == torch.float32 and a.device == dev and a.shape == shape
                and a.is_contiguous()):
            _reject(name, a, shape, dev)
    if lengths is not None and not (lengths.dtype == torch.int32 and lengths.device == dev
                                    and lengths.shape == x.shape[:1]
                                    and lengths.is_contiguous()):
        raise ValueError("adain_snake: lengths must be None or a contiguous (B,) int32 "
                         "tensor on x's device")
    if x.numel() == 0:
        raise ValueError("adain_snake: empty input")


def _reject(name, a, shape, dev):
    if a.device != dev:
        raise ValueError(f"adain_snake: {name} on {a.device}, x on {dev}")
    if a.dtype != torch.float32:
        raise TypeError(f"adain_snake: {name} is {a.dtype}, needs float32")
    if a.shape != shape:
        raise ValueError(f"adain_snake: {name} has shape {tuple(a.shape)}, needs "
                         f"{tuple(shape)}")
    raise ValueError(f"adain_snake: {name} is not contiguous")


def _args(x, gamma, beta, alpha):
    b, c, _ = x.shape
    return (("gamma", gamma, (b, c)), ("beta", beta, (b, c)), ("alpha", alpha, (c,)))


def _stream(x):
    return x.device.index, torch.cuda.current_stream(x.device).cuda_stream


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a``, or a copy of it when its data does not start on a 16-byte
    boundary (a view with a storage offset): the kernels load each row's
    body as 16-byte vectors from that boundary."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


def plan(t: int, backward: bool = False) -> str:
    """The path a row of ``t`` frames takes on the current CUDA device:
    ``"rows GxV"`` (G threads per row, V 16-byte vectors each, the row in
    registers), ``"long, shared-memory cache"`` or ``"long, L2 re-read"``."""
    path, threads, vecs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().adain_snake_plan(t, int(backward), torch.cuda.current_device(),
                                 ctypes.byref(path), ctypes.byref(threads), ctypes.byref(vecs))
    if rc != 0:
        raise RuntimeError(f"adain_snake_plan failed: cudaError_t {rc}")
    return {0: f"rows {threads.value}x{vecs.value}", 1: "long, shared-memory cache",
            2: "long, L2 re-read"}[path.value]


def adain_snake_fwd(x, gamma, beta, alpha, lengths=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1f on CUDA tensors: (y, mean, rstd)."""
    _check(x, lengths, _args(x, gamma, beta, alpha))
    return _fwd(x, gamma, beta, alpha, lengths)


def _fwd(x, gamma, beta, alpha, lengths):
    """K1f on checked inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"adain_snake_fwd: no kernel for device {x.device}")
    b, c, t = x.shape
    x = _aligned(x)
    y = torch.empty_like(x)
    mean, rstd = torch.empty_like(gamma), torch.empty_like(gamma)
    rc = _lib().adain_snake_fwd_f32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), alpha.data_ptr(),
        None if lengths is None else lengths.data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), b, c, t, *_stream(x))
    if rc != 0:
        raise RuntimeError(f"adain_snake forward kernel launch failed: cudaError_t {rc}")
    global fwd_launches
    fwd_launches += 1
    return y, mean, rstd


def adain_snake_bwd(x, gamma, beta, alpha, mean, rstd, lengths, dy
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1b on CUDA tensors: (dx, dgamma, dbeta, dalpha per row (B, C))."""
    b, c, t = x.shape
    _check(x, lengths, _args(x, gamma, beta, alpha)
           + (("mean", mean, (b, c)), ("rstd", rstd, (b, c)), ("dy", dy, (b, c, t))))
    return _bwd(x, gamma, beta, alpha, mean, rstd, lengths, dy)


def _bwd(x, gamma, beta, alpha, mean, rstd, lengths, dy):
    """K1b on checked inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"adain_snake_bwd: no kernel for device {x.device}")
    b, c, t = x.shape
    x, dy = _aligned(x), _aligned(dy)
    dx = torch.empty_like(x)
    dgamma, dbeta, dalpha = (torch.empty_like(gamma) for _ in range(3))
    rc = _lib().adain_snake_bwd_f32(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), alpha.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), None if lengths is None else lengths.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dalpha.data_ptr(), b, c, t,
        *_stream(x))
    if rc != 0:
        raise RuntimeError(f"adain_snake backward kernel launch failed: cudaError_t {rc}")
    global bwd_launches
    bwd_launches += 1
    return dx, dgamma, dbeta, dalpha


class AdainSnake(torch.autograd.Function):
    """K1f forward, K1b backward; saves x, gamma, beta, alpha, (mean, rstd)
    and lengths, as the Pallas VJP does."""

    @staticmethod
    def forward(ctx, x, gamma, beta, alpha, lengths):
        y, mean, rstd = adain_snake_fwd(x, gamma, beta, alpha, lengths)
        ctx.save_for_backward(x, gamma, beta, alpha, mean, rstd, lengths)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, alpha, mean, rstd, lengths = ctx.saved_tensors
        # the saved tensors passed the forward's checks, and autograd gives
        # dy y's shape, dtype and device
        dx, dg, db, da = _bwd(x, gamma, beta, alpha, mean, rstd, lengths, dy.contiguous())
        return dx, dg, db, da.sum(0), None


def adain_snake(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                alpha: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``snake(adain(x), alpha)``.  x (B, C, T) f32; gamma, beta (B, C);
    alpha (C,); lengths None or (B,) int32.  Differentiable in x, gamma,
    beta and alpha on both routes."""
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(a.requires_grad for a in (x, gamma, beta, alpha))):
        return AdainSnake.apply(x, gamma, beta, alpha, lengths)    # checks in its forward
    _check(x, lengths, _args(x, gamma, beta, alpha))
    if x.device.type == "cpu":
        return adain_snake_plain(x, gamma, beta, alpha, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"adain_snake: no kernel for device {x.device}")
    return _fwd(x, gamma, beta, alpha, lengths)[0]


def mean_rstd_plain(x: torch.Tensor, lengths: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) (B, C) over the frames ``< lengths`` (all when None):
    ``mrf_round.masked_stats``, the centred two-pass variance."""
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[-1], dtype=torch.int32, device=x.device)
    return masked_stats(x, lengths)


def adain_snake_plain(x, gamma, beta, alpha, lengths=None) -> torch.Tensor:
    """The same function as a torch composition (any device)."""
    mean, rstd = mean_rstd_plain(x, lengths)
    u = ((x - mean[:, :, None]) * rstd[:, :, None] * (1.0 + gamma)[:, :, None]
         + beta[:, :, None])
    return snake(u, alpha[None, :, None])


def adain_snake_bwd_plain(x, gamma, beta, alpha, mean, rstd, lengths, dy):
    """K1b's closed form as a torch composition: (dx, dgamma, dbeta, dalpha
    per row (B, C)), every sum over all T frames."""
    t = x.shape[-1]
    g1, be, a = (1.0 + gamma)[:, :, None], beta[:, :, None], alpha[None, :, None]
    xh = (x - mean[:, :, None]) * rstd[:, :, None]
    u = g1 * xh + be
    sau, s2au = torch.sin(a * u), torch.sin(2.0 * a * u)
    du = dy * (1.0 + s2au)
    dalpha = torch.sum(dy * (u * s2au / a - sau * sau / (a * a)), dim=-1)
    dbeta = du.sum(-1)
    dgamma = (du * xh).sum(-1)
    dxh = du * g1
    n_valid = t if lengths is None else torch.clamp(lengths, 0, t)
    n = torch.clamp(torch.as_tensor(n_valid, device=x.device), min=1).to(x.dtype)
    n = n.reshape(-1, 1, 1)
    corr = (dxh.sum(-1, keepdim=True) + xh * (dxh * xh).sum(-1, keepdim=True)) / n
    if lengths is not None:
        keep = torch.arange(t, device=x.device)[None, None, :] < lengths[:, None, None]
        corr = torch.where(keep, corr, torch.zeros_like(corr))
    return rstd[:, :, None] * (dxh - corr), dgamma, dbeta, dalpha
