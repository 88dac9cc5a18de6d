"""
ctypes bindings for the host DSP library ``native/dsp/dsp_kernels.c`` (a
byte-for-byte copy of the JAX package's), compiled on first use like the
FLAC codec (copied from ``lhotse_tpu/ops/host_dsp.py``). Only the functions
the port calls are bound:

- ``adpcm4_encode`` and ``mulaw_encode_lut``, the host wire encoders of
  :mod:`lhotse_tpu_torch.ops.wire` (bit-exact against its numpy encoders);
- ``scale_i32_to_f32``, the FLAC decoder's PCM normalisation;
- ``sinc_resample``, the polyphase sinc resampler of
  :mod:`lhotse_tpu_torch.augmentation.resample` (speed perturbation and
  resampling on the host).

A failed build raises: there is no numpy fallback here, and no function
returns ``None``.
"""
from __future__ import annotations

import ctypes
import threading

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

        lib = build_native("dsp", "dsp_kernels.c", extra_link=["-lm"])
        lib.scale_i32_to_f32.restype = None
        lib.scale_i32_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float)]
        lib.adpcm4_encode_f32.restype = None
        lib.adpcm4_encode_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_ubyte)]
        lib.mulaw_encode_lut_f32.restype = None
        lib.mulaw_encode_lut_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte)]
        lib.sinc_resample_f32.restype = None
        lib.sinc_resample_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
        return _LIB


def adpcm4_encode(x: np.ndarray, num_samples: int, width: int) -> np.ndarray:
    """Native 4-bit block-ADPCM encode of float32 ``(N, T)`` rows into
    ``(N, width)`` uint8 wire rows (bit-exact vs the numpy reference encoder
    in ops/wire.py)."""
    lib = _get_lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    n_rows = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    out = np.empty((*x.shape[:-1], width), dtype=np.uint8)
    lib.adpcm4_encode_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_rows,
        num_samples, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out


def mulaw_encode_lut(x: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Native one-pass mu-law encode via a caller-built 65536-entry LUT."""
    lib = _get_lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    assert lut.size == 65536
    out = np.empty(x.shape, dtype=np.uint8)
    lib.mulaw_encode_lut_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size,
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out


def scale_i32_to_f32(pcm: np.ndarray, scale: float) -> np.ndarray:
    """One-pass ``pcm.astype(f32) * scale``."""
    lib = _get_lib()
    pcm = np.ascontiguousarray(pcm, dtype=np.int32)
    out = np.empty(pcm.shape, dtype=np.float32)
    lib.scale_i32_to_f32(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), pcm.size,
        float(scale), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def sinc_resample(padded: np.ndarray, num_blocks: int, kernel: np.ndarray, orig: int) -> np.ndarray:
    """
    Polyphase resample of one already-padded float32 waveform with a
    (phases, K) float32 kernel; returns the raw (num_blocks * phases,)
    output (the caller trims).
    """
    lib = _get_lib()
    padded = np.ascontiguousarray(padded, dtype=np.float32)
    kernel = np.ascontiguousarray(kernel, dtype=np.float32)
    phases, K = kernel.shape
    assert padded.shape[-1] >= (num_blocks - 1) * orig + K
    out = np.empty(num_blocks * phases, dtype=np.float32)
    lib.sinc_resample_f32(
        padded.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_blocks,
        kernel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), phases, K, orig,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
