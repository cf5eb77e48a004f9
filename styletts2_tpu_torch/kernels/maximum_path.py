"""The monotonic maximum path of stage-1 training: the CUDA kernel of
``csrc/maximum_path.cu`` and its plain PyTorch version.

Port of ``styletts2_tpu/ops/pallas/monotonic_kernel.py::maximum_path_pallas``
and bit-exact with ``styletts2_tpu/ops/monotonic.py::maximum_path``: per
batch element, the forward max-path DP over mel frames within the text and
mel lengths (NEG_INF -1e9), then the backtrack, giving a one-hot path
(B, T_text, T_mel) with one token per valid mel frame.

``maximum_path`` takes a tensor on the CPU to ``maximum_path_plain`` and a
CUDA tensor to the kernel; anything else raises.  ``launches`` counts kernel
launches.  The path is a constant: there is no backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e9

launches = 0

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("maximum_path")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maximum_path_f32.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.maximum_path_f32.restype = i
        _LIB = lib
    return _LIB


def _check(values, text_lengths, mel_lengths):
    if values.dim() != 3:
        raise ValueError(f"maximum_path: values has shape {tuple(values.shape)}, "
                         "needs (B, T_text, T_mel)")
    if values.dtype != torch.float32 or not values.is_contiguous():
        raise TypeError("maximum_path: values must be contiguous float32")
    if values.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("maximum_path has no backward: pass detached values")
    b, t_text, _ = values.shape
    for name, a in (("text_lengths", text_lengths), ("mel_lengths", mel_lengths)):
        if a.device != values.device or a.dtype != torch.int32 or tuple(a.shape) != (b,) \
                or not a.is_contiguous():
            raise ValueError(f"maximum_path: {name} must be a contiguous (B,) int32 "
                             "tensor on the values' device")
    if b < 1 or t_text < 1 or values.shape[2] < 1 or t_text > 6144:
        raise ValueError(f"maximum_path: unsupported shape {tuple(values.shape)}")


def maximum_path(values: torch.Tensor, text_lengths: torch.Tensor,
                 mel_lengths: torch.Tensor) -> torch.Tensor:
    """values (B, T_text, T_mel) f32, lengths (B,) int32 -> one-hot path
    (B, T_text, T_mel) f32."""
    _check(values, text_lengths, mel_lengths)
    if values.device.type == "cpu":
        return maximum_path_plain(values, text_lengths, mel_lengths)
    if values.device.type != "cuda":
        raise ValueError(f"maximum_path: no kernel for device {values.device}")
    b, t_text, t_mel = values.shape
    rows = torch.empty((b, t_mel, t_text), device=values.device, dtype=torch.float32)
    path = torch.empty_like(values)
    rc = _lib().maximum_path_f32(
        values.data_ptr(), text_lengths.data_ptr(), mel_lengths.data_ptr(), rows.data_ptr(),
        path.data_ptr(), b, t_text, t_mel, values.device.index,
        torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"maximum_path kernel launch failed: cudaError_t {rc}")
    global launches
    launches += 1
    return path


@torch.no_grad()
def maximum_path_plain(values: torch.Tensor, text_lengths: torch.Tensor,
                       mel_lengths: torch.Tensor) -> torch.Tensor:
    """The loop form of ``styletts2_tpu/ops/monotonic.py::maximum_path``
    (any device): the text axis vectorised, one step per mel frame."""
    b, t_text, t_mel = values.shape
    dev = values.device
    x_idx = torch.arange(t_text, device=dev)[None, :]
    valid_x = x_idx < text_lengths[:, None].long()
    neg = torch.full((b, t_text), NEG_INF, dtype=torch.float32, device=dev)
    prev = neg
    rows = []
    for y in range(t_mel):
        stay = torch.where(x_idx == y, neg, prev)
        advance = torch.cat([neg[:, :1], prev[:, :-1]], dim=1)
        best = torch.maximum(stay, advance)
        if y == 0:
            best = torch.where(x_idx == 0, torch.zeros_like(best), best)
        best = torch.where(x_idx > y, neg, best)
        prev = torch.where(valid_x, best + values[:, :, y], neg)
        rows.append(prev)

    tl, ml = text_lengths.long(), mel_lengths.long()
    path = torch.zeros((b, t_text, t_mel), dtype=torch.float32, device=dev)
    idx = torch.zeros((b,), dtype=torch.long, device=dev)
    arange_b = torch.arange(b, device=dev)
    for y in range(t_mel - 1, -1, -1):
        idx = torch.where(y == ml - 1, tl - 1, idx)
        active = y < ml
        path[:, :, y] = ((x_idx == idx[:, None]) & active[:, None]).float()
        v_prev = rows[y - 1] if y > 0 else neg
        v_at = v_prev[arange_b, idx.clamp(0, t_text - 1)]
        v_left = v_prev[arange_b, (idx - 1).clamp(0, t_text - 1)]
        move = (idx != 0) & ((idx == y) | (v_at < v_left)) & active
        idx = torch.where(move, idx - 1, idx)
    return path
