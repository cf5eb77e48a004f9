"""ctypes bindings for the native host runtime (native/styletts2_native.cpp),
the port's copy of ``styletts2_tpu/native.py``.

Builds on demand with ``make -C native`` and degrades gracefully to the pure
numpy paths when a compiler is unavailable.  Host code for the data
pipeline: WAV resampling and FLAC/OGG/MP3 decoding, and the host-side
monotonic DP.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libstyletts2_native.so")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception as exc:
            logger.info("native build unavailable (%s); using pure fallbacks", exc)
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as exc:
        logger.info("native load failed (%s); using pure fallbacks", exc)
        return None

    if not hasattr(lib, "flac_decode"):
        # stale build from before the FLAC decoder existed: rebuild once
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-B"], check=True,
                           capture_output=True, timeout=120)
            lib = ctypes.CDLL(_LIB_PATH)
        except Exception as exc:
            logger.info("native rebuild failed (%s); FLAC decode disabled", exc)

    lib.maximum_path.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.resample_poly.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pcm16_to_float.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    if hasattr(lib, "flac_decode"):
        lib.flac_stream_info.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.flac_stream_info.restype = ctypes.c_int
        lib.flac_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.flac_decode.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def maximum_path_host(values: np.ndarray, text_lengths: np.ndarray,
                      mel_lengths: np.ndarray) -> np.ndarray:
    """Host-native monotonic DP (b, t_text, t_mel) -> int32 one-hot paths."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    b, t_text, t_mel = values.shape
    paths = np.zeros_like(values, dtype=np.int32)
    tx = np.ascontiguousarray(text_lengths, dtype=np.int32)
    ty = np.ascontiguousarray(mel_lengths, dtype=np.int32)
    if lib is None:
        # numpy fallback (same DP)
        for i in range(b):
            paths[i] = _numpy_dp(values[i], int(tx[i]), int(ty[i]))
        return paths
    lib.maximum_path(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b, t_text, t_mel,
        tx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ty.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return paths


def _numpy_dp(value: np.ndarray, tx: int, ty: int) -> np.ndarray:
    neg = -1e9
    t_text, t_mel = value.shape
    v = np.full_like(value, neg, dtype=np.float64)
    for y in range(ty):
        for x in range(max(0, tx + y - ty), min(tx, y + 1)):
            v_cur = neg if (x == y or y == 0) else v[x, y - 1]
            if x == 0:
                v_prev = 0.0 if y == 0 else neg
            else:
                v_prev = neg if y == 0 else v[x - 1, y - 1]
            v[x, y] = max(v_prev, v_cur) + value[x, y]
    path = np.zeros((t_text, t_mel), np.int32)
    index = tx - 1
    for y in range(ty - 1, -1, -1):
        path[index, y] = 1
        if index != 0 and (index == y or (y > 0 and v[index, y - 1] < v[index - 1, y - 1])):
            index -= 1
    return path


def resample_host(wave: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Host-native polyphase resampling for the data pipeline (the kernels
    of the port's ``audio/resample.py``)."""
    from .audio.resample import _sinc_kernel

    if orig_freq == new_freq:
        return np.asarray(wave, np.float32)
    kernels, width, orig, new = _sinc_kernel(orig_freq, new_freq)
    wave = np.ascontiguousarray(wave, np.float32)
    padded = np.pad(wave, (width, width + orig)).astype(np.float32)
    n_out = int(np.ceil(new_freq * len(wave) / orig_freq))
    out = np.zeros(n_out, np.float32)
    lib = _load()
    if lib is None:
        frames = (len(padded) - kernels.shape[1]) // orig + 1
        strided = np.lib.stride_tricks.sliding_window_view(padded, kernels.shape[1])[::orig]
        full = strided @ kernels.T
        return full.reshape(-1)[:n_out].astype(np.float32)
    kernels = np.ascontiguousarray(kernels, np.float32)
    lib.resample_poly(
        padded.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(padded),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out,
        kernels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        kernels.shape[0], kernels.shape[1], orig,
    )
    return out


def read_flac(path: str):
    """Decode a FLAC file via the in-tree native decoder
    (native/flac_decoder.cpp).

    Returns ``(float32 mono waveform in [-1, 1], sample_rate)``.  Raises
    ``RuntimeError`` when the native library is unavailable or the file is
    not decodable (callers map this to the unreadable-audio skip path).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "flac_decode"):
        raise RuntimeError("native FLAC decoder unavailable (build native/)")
    data = np.fromfile(path, dtype=np.uint8)
    if data.size < 42:
        raise RuntimeError(f"not a FLAC file: {path}")
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    bps = ctypes.c_int32()
    total = ctypes.c_int64()
    rc = lib.flac_stream_info(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), data.size,
        ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(bps),
        ctypes.byref(total))
    if rc != 0:
        raise RuntimeError(f"bad FLAC stream info: {path}")
    # STREAMINFO may omit the total; start from the compressed size and grow
    capacity = int(total.value) or max(1 << 16, data.size * 2)
    for _ in range(8):
        out = np.empty(capacity * ch.value, dtype=np.int32)
        decoded = ctypes.c_int64()
        rc = lib.flac_decode(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), data.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), capacity,
            ctypes.byref(decoded))
        if rc == -2:
            capacity *= 4
            continue
        if rc != 0:
            raise RuntimeError(f"FLAC decode failed: {path}")
        frames = int(decoded.value)
        mono = out[: frames * ch.value].reshape(frames, ch.value)[:, 0]
        scale = float(1 << (bps.value - 1))
        return (mono.astype(np.float32) / scale), int(sr.value)
    raise RuntimeError(f"FLAC decode exceeded capacity growth: {path}")


# ---------------------------------------------------------------- system codecs
#
# Best-effort decoders over system libraries when present (no dev headers
# needed — pure ctypes).  The reference reads these formats through
# soundfile/torchaudio (ref: meldataset.py:149-170); WAV/FLAC are the fully
# in-tree paths, OGG/MP3 ride the distro libs when available.


class _VorbisInfo(ctypes.Structure):
    _fields_ = [("version", ctypes.c_int), ("channels", ctypes.c_int),
                ("rate", ctypes.c_long), ("bitrate_upper", ctypes.c_long),
                ("bitrate_nominal", ctypes.c_long),
                ("bitrate_lower", ctypes.c_long),
                ("bitrate_window", ctypes.c_long)]


def read_ogg(path: str):
    """Decode OGG/Vorbis via libvorbisfile (if installed).

    Returns (float32 mono waveform, sample_rate); RuntimeError when the
    library is missing or the file is invalid.
    """
    try:
        vf = ctypes.CDLL("libvorbisfile.so.3")
    except OSError as exc:
        raise RuntimeError(f"libvorbisfile unavailable: {exc}") from exc
    vf.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    vf.ov_fopen.restype = ctypes.c_int
    vf.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vf.ov_info.restype = ctypes.POINTER(_VorbisInfo)
    vf.ov_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]
    vf.ov_read.restype = ctypes.c_long
    vf.ov_clear.argtypes = [ctypes.c_void_p]

    ovf = ctypes.create_string_buffer(4096)  # > sizeof(OggVorbis_File)
    if vf.ov_fopen(path.encode(), ovf) != 0:
        raise RuntimeError(f"not a decodable OGG/Vorbis file: {path}")
    try:
        info = vf.ov_info(ovf, -1).contents
        ch, sr = int(info.channels), int(info.rate)
        chunks = []
        buf = ctypes.create_string_buffer(65536)
        bs = ctypes.c_int(0)
        while True:
            n = vf.ov_read(ovf, buf, len(buf), 0, 2, 1, ctypes.byref(bs))
            if n < 0:
                raise RuntimeError(f"OGG decode error {n}: {path}")
            if n == 0:
                break
            chunks.append(np.frombuffer(buf.raw[:n], dtype=np.int16).copy())
    finally:
        vf.ov_clear(ovf)
    if not chunks:
        raise RuntimeError(f"empty OGG stream: {path}")
    pcm = np.concatenate(chunks)
    mono = pcm.reshape(-1, ch)[:, 0] if ch > 1 else pcm
    return mono.astype(np.float32) / 32768.0, sr


def read_mp3(path: str):
    """Decode MP3 via libmpg123 (if installed)."""
    try:
        mg = ctypes.CDLL("libmpg123.so.0")
    except OSError as exc:
        raise RuntimeError(f"libmpg123 unavailable: {exc}") from exc
    mg.mpg123_init()
    mg.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    mg.mpg123_new.restype = ctypes.c_void_p
    mg.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    mg.mpg123_getformat.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_long),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
    mg.mpg123_format_none.argtypes = [ctypes.c_void_p]
    mg.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                 ctypes.c_int, ctypes.c_int]
    mg.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    mg.mpg123_close.argtypes = [ctypes.c_void_p]
    mg.mpg123_delete.argtypes = [ctypes.c_void_p]
    err = ctypes.c_int(0)
    h = mg.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError("mpg123_new failed")
    try:
        if mg.mpg123_open(h, path.encode()) != 0:
            raise RuntimeError(f"not a decodable MP3: {path}")
        rate = ctypes.c_long(0)
        ch = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if mg.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(ch),
                               ctypes.byref(enc)) != 0:
            raise RuntimeError(f"mpg123_getformat failed: {path}")
        # force 16-bit signed output at the native rate
        mg.mpg123_format_none(h)
        MPG123_ENC_SIGNED_16 = 0xD0
        mg.mpg123_format(h, rate, ch, MPG123_ENC_SIGNED_16)
        chunks = []
        buf = ctypes.create_string_buffer(65536)
        done = ctypes.c_size_t(0)
        MPG123_NEW_FORMAT = 1
        while True:
            rc = mg.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[: done.value],
                                            dtype=np.int16).copy())
            if rc == MPG123_NEW_FORMAT:
                continue
            if rc != 0:  # MPG123_OK=0; MPG123_DONE=-12 or any error ends
                break
        if not chunks:
            raise RuntimeError(f"empty MP3 stream: {path}")
        pcm = np.concatenate(chunks)
        nch = max(1, int(ch.value))
        mono = pcm.reshape(-1, nch)[:, 0] if nch > 1 else pcm
        return mono.astype(np.float32) / 32768.0, int(rate.value)
    finally:
        mg.mpg123_close(h)
        mg.mpg123_delete(h)
