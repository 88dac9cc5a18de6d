"""
FLAC decode/encode through the package's native codec
(``native/flac/flac_codec.c``, a byte-for-byte copy of the JAX package's),
loaded with ctypes (copied from ``lhotse_tpu/audio/flacio.py``). The
library is compiled on first use with the system C compiler
(:mod:`lhotse_tpu_torch.native_build`); without it, reading or writing
FLAC raises.

- ``read_flac(path_or_fd) -> (samples (channels, frames) float32, sr)``
- ``info_flac(path_or_fd) -> FlacInfo``
- ``write_flac(dest, samples, sampling_rate, bits_per_sample=16)``
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Tuple, Union

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()


def _get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from lhotse_tpu_torch.native_build import build_native

        lib = build_native("flac", "flac_codec.c")
        lib.flac_parse_info.restype = ctypes.c_int
        lib.flac_parse_info.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.flac_decode.restype = ctypes.c_longlong
        lib.flac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong]
        lib.flac_encode.restype = ctypes.c_longlong
        lib.flac_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
        _LIB = lib
        return _LIB


@dataclass
class FlacInfo:
    num_channels: int
    sampling_rate: int
    bits_per_sample: int
    num_frames: int


def _read_bytes(path_or_fd: Union[str, Path, BinaryIO, bytes]) -> bytes:
    if isinstance(path_or_fd, bytes):
        return path_or_fd
    if isinstance(path_or_fd, (str, Path)):
        with open(path_or_fd, "rb") as f:
            return f.read()
    # file-like
    pos = path_or_fd.tell() if path_or_fd.seekable() else None
    data = path_or_fd.read()
    if pos is not None:
        path_or_fd.seek(pos)
    return data


def info_flac(path_or_fd) -> FlacInfo:
    """Parse STREAMINFO without decoding audio."""
    data = _read_bytes(path_or_fd)
    lib = _get_lib()
    ch = ctypes.c_int()
    sr = ctypes.c_int()
    bps = ctypes.c_int()
    total = ctypes.c_longlong()
    rc = lib.flac_parse_info(
        data, len(data), ctypes.byref(ch), ctypes.byref(sr), ctypes.byref(bps), ctypes.byref(total))
    if rc != 0:
        raise ValueError(f"Not a valid FLAC stream (error {rc}).")
    return FlacInfo(
        num_channels=ch.value, sampling_rate=sr.value, bits_per_sample=bps.value,
        num_frames=int(total.value))


def read_flac(path_or_fd) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream → ((channels, frames) float32 in [-1, 1], sr)."""
    data = _read_bytes(path_or_fd)
    info = info_flac(data)
    lib = _get_lib()
    total = info.num_frames
    if total <= 0:
        # STREAMINFO may omit the length; allow a generous upper bound.
        total = max(1, len(data) * 4 // max(1, info.num_channels))
    out = np.empty(total * info.num_channels, dtype=np.int32)
    decoded = lib.flac_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), total)
    if decoded < 0:
        raise ValueError(f"FLAC decode failed (error {decoded}).")
    pcm = out[: decoded * info.num_channels].reshape(decoded, info.num_channels)
    scale = 1.0 / float(1 << (info.bits_per_sample - 1))
    from lhotse_tpu_torch.ops import host_dsp

    return host_dsp.scale_i32_to_f32(pcm, scale).T, info.sampling_rate


def write_flac(dest, samples: np.ndarray, sampling_rate: int, bits_per_sample: int = 16) -> None:
    """
    Encode float samples (``(channels, frames)`` or ``(frames,)`` in [-1, 1],
    or integer PCM) to FLAC at ``dest`` (path or writable file-like).
    """
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, frames = samples.shape

    if np.issubdtype(samples.dtype, np.floating):
        scale = float(1 << (bits_per_sample - 1))
        pcm = np.clip(np.rint(samples * scale), -scale, scale - 1).astype(np.int32)
    else:
        pcm = samples.astype(np.int32)

    interleaved = np.ascontiguousarray(pcm.T).reshape(-1)

    lib = _get_lib()
    # Worst case: verbatim subframes + headers; generous headroom.
    cap = interleaved.nbytes + frames * channels // 2 + (frames // 4096 + 2) * 64 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.flac_encode(
        interleaved.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), frames, channels,
        int(sampling_rate), int(bits_per_sample),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError(f"FLAC encode failed (error {n}).")
    payload = bytearray(out[:n].tobytes())
    # Fill the STREAMINFO PCM MD5 (file offset 26 = 4 magic + 4 block header
    # + 18 into the STREAMINFO payload) so strict decoders can verify us.
    if bits_per_sample == 16:
        import hashlib

        md5 = hashlib.md5(np.ascontiguousarray(pcm.T).astype("<i2").tobytes()).digest()
        payload[26:42] = md5
    payload = bytes(payload)
    if isinstance(dest, (str, Path)):
        with open(dest, "wb") as f:
            f.write(payload)
    else:
        dest.write(payload)
