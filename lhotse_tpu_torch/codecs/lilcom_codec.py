"""
Lossy float-array compression codec, the LTC1 bitstream (copied from
``lhotse_tpu/codecs/lilcom_codec.py``): ``compress(array, tick_power=...)
-> bytes`` quantizes to integer multiples of ``2^tick_power`` and
``decompress(bytes) -> array`` restores it, with ``decompress_concat`` for
back-to-back chunks of one archive read.

Bitstream ("LTC1"):
  magic  4 bytes  b"LTC1"
  method 1 byte   0 = zlib-compressed zigzag-delta ticks, 1 = per-row bit-packing
  tickp  1 byte   int8 tick_power
  ndim   1 byte
  itemsz 1 byte   width of stored integers (1, 2, or 4 bytes; method 0)
  shape  ndim * uint32 LE
  payload

Round-trip error is bounded by 2^(tick_power-1). float32 input is encoded by
the C codec ``native/lilcom/ltc1.c`` (a byte-for-byte copy of the JAX
package's; method 1); float64 input keeps the numpy method-0 path, whose
quantization runs in float64. Decoding takes the C codec, with numpy
decoders of both methods behind it. The C codec is built on first use, and
a failed build raises. Payloads that are not LTC1 are read with the pip
``lilcom`` package when it is installed, and ``compress`` can be pinned to
it with ``LHOTSE_TPU_USE_PIP_LILCOM=1``, as in the JAX package.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from lhotse_tpu_torch.utils import is_module_available

_MAGIC = b"LTC1"


def _use_pip_lilcom() -> bool:
    return os.environ.get("LHOTSE_TPU_USE_PIP_LILCOM") == "1" and is_module_available("lilcom")


_NATIVE = None


def _native_lib():
    """The C LTC1 codec (same bitstream), built on first use; raises when the
    build fails."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    import ctypes

    from lhotse_tpu_torch.native_build import build_native

    lib = build_native("lilcom", "ltc1.c", extra_link=["-lz"])
    sig = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
    lib.ltc1_compress.restype = ctypes.c_longlong
    lib.ltc1_compress.argtypes = sig
    lib.ltc1_compress_rowpack.restype = ctypes.c_longlong
    lib.ltc1_compress_rowpack.argtypes = sig
    lib.ltc1_compress_bound.restype = ctypes.c_longlong
    lib.ltc1_compress_bound.argtypes = [ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
    lib.ltc1_parse_header.restype = ctypes.c_int
    lib.ltc1_parse_header.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ltc1_decompress.restype = ctypes.c_longlong
    lib.ltc1_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
    lib.ltc1_decompress_concat.restype = ctypes.c_longlong
    lib.ltc1_decompress_concat.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
    _NATIVE = lib
    return _NATIVE


def compress(data: np.ndarray, tick_power: int = -5, do_regression: bool = True) -> bytes:
    """
    Lossily compress a floating-point numpy array, quantizing values to
    integer multiples of ``2^tick_power``.
    """
    if _use_pip_lilcom():
        import lilcom

        return lilcom.compress(data, tick_power=tick_power)

    data = np.asarray(data)
    assert np.issubdtype(data.dtype, np.floating), (
        "This codec supports only floating-point arrays."
    )

    # float64 inputs keep the numpy path: its quantization runs in f64 and a
    # pre-cast to f32 could change ticks at the rounding boundary.
    if data.ndim >= 1 and data.size > 0 and data.dtype == np.float32:
        import ctypes

        native = _native_lib()
        arr = np.ascontiguousarray(data, dtype=np.float32)
        shape = np.array(arr.shape, dtype=np.uint32)
        shape_p = shape.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        cap = int(native.ltc1_compress_bound(shape_p, arr.ndim))
        out = np.empty(cap, dtype=np.uint8)
        # Method 1 (per-row bit-packing): ~15x faster than deflate at a
        # comparable ratio on smooth feature matrices.
        n = native.ltc1_compress_rowpack(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), shape_p, arr.ndim, int(tick_power),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n > 0:
            return out[:n].tobytes()
        # On any native failure, fall through to the numpy path.
    scale = float(2.0 ** (-tick_power))
    ticks = np.rint(data.astype(np.float64) * scale)
    np.clip(ticks, -(2**31) + 1, 2**31 - 1, out=ticks)
    ticks = ticks.astype(np.int64)

    # Delta-code along the time axis (axis 0) — features are smooth in time,
    # so residuals are small and compress well.
    if do_regression and data.ndim >= 1 and data.shape[0] > 1:
        resid = np.diff(ticks, axis=0, prepend=ticks[:1] * 0)
        resid[0] = ticks[0]
    else:
        resid = ticks
    # Zigzag map to unsigned so small negatives stay small.
    zz = (resid << 1) ^ (resid >> 63)
    maxv = int(zz.max()) if zz.size else 0
    if maxv < 1 << 8:
        itemsize, dtype = 1, "<u1"
    elif maxv < 1 << 16:
        itemsize, dtype = 2, "<u2"
    else:
        itemsize, dtype = 4, "<u4"
    payload = zlib.compress(zz.astype(dtype).tobytes(), 4)

    header = _MAGIC + struct.pack("<Bbbb", 0, np.int8(tick_power), data.ndim, itemsize)
    header += struct.pack(f"<{data.ndim}I", *data.shape)
    return header + payload


def _rowpack_decode_numpy(data: bytes, pos: int, shape) -> np.ndarray:
    """Pure-numpy decoder for method 1 (per-row LSB-first bit packing)."""
    rows = shape[0] if len(shape) else 0
    inner = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    resid = np.zeros((rows, inner), dtype=np.int64)
    buf = np.frombuffer(data, dtype=np.uint8)
    for r in range(rows):
        w = int(buf[pos])
        pos += 1
        if w == 0:
            continue
        packed = (inner * w + 7) // 8
        bits = np.unpackbits(buf[pos : pos + packed], bitorder="little")
        pos += packed
        vals = bits[: inner * w].reshape(inner, w).astype(np.int64)
        u = (vals << np.arange(w, dtype=np.int64)).sum(axis=1)
        resid[r] = (u >> 1) ^ -(u & 1)
    return resid.reshape(shape)


def decompress_concat(
    data: bytes, sizes, max_rows: int
) -> Optional[np.ndarray]:
    """
    One native call decoding back-to-back LTC1 chunks that share trailing
    dimensions (a contiguous ``.lca`` chunk range read in one pread):
    avoids a ctypes round trip + numpy buffer per chunk and the final
    concatenate. ``sizes`` are the compressed chunk sizes; ``max_rows``
    bounds the output allocation (the caller knows the per-chunk frame
    count). Returns None when the payload is not LTC1 (caller falls back to
    per-chunk decode).
    """
    if len(data) < 8 or data[:4] != _MAGIC:
        return None
    native = _native_lib()
    import ctypes

    shape_arr = np.zeros(8, dtype=np.uint32)
    nd = ctypes.c_int()
    tp = ctypes.c_int()
    if (
        native.ltc1_parse_header(
            data, len(data),
            shape_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.byref(nd), ctypes.byref(tp)) != 0
    ):
        return None
    inner_shape = tuple(int(s) for s in shape_arr[1 : nd.value])
    inner = int(np.prod(inner_shape)) if inner_shape else 1
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    max_elems = int(max_rows) * inner
    out = np.empty(max_elems, dtype=np.float32)
    n = native.ltc1_decompress_concat(
        data, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(sizes), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_elems)
    if n < 0 or n % max(1, inner) != 0:
        return None
    return out[:n].reshape((n // inner,) + inner_shape)


def decompress(data: bytes, dtype: Optional[np.dtype] = None) -> np.ndarray:
    """
    Decompress bytes produced by :func:`compress` (or, when the optional pip
    ``lilcom`` package is installed, by the original C lilcom).
    """
    if data[:4] != _MAGIC:
        if is_module_available("lilcom"):
            import lilcom

            out = lilcom.decompress(data)
            return out.astype(dtype) if dtype is not None else out
        raise ValueError(
            "Unrecognized compressed payload: not an LTC1 stream, and the "
            "'lilcom' package is not installed to try decoding legacy data."
        )
    method = data[4]
    if method not in (0, 1):
        raise ValueError(f"Unsupported LTC1 method: {method}")
    import ctypes

    native = _native_lib()
    shape_arr = np.zeros(8, dtype=np.uint32)
    nd = ctypes.c_int()
    tp = ctypes.c_int()
    rc = native.ltc1_parse_header(
        data, len(data), shape_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(nd), ctypes.byref(tp))
    if rc == 0:
        shape = tuple(int(s) for s in shape_arr[: nd.value])
        elems = int(np.prod(shape)) if shape else 0
        out = np.empty(elems, dtype=np.float32)
        n = native.ltc1_decompress(
            data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), elems)
        if n == elems:
            result = out.reshape(shape)
            return result.astype(dtype) if dtype is not None else result
    # Fall through to the numpy path on any native failure.
    return _decompress_numpy(data, dtype)


def _decompress_numpy(data: bytes, dtype: Optional[np.dtype] = None) -> np.ndarray:
    """The numpy decoders of both LTC1 methods."""
    method, tick_power, ndim, itemsize = struct.unpack("<Bbbb", data[4:8])
    shape = struct.unpack(f"<{ndim}I", data[8 : 8 + 4 * ndim])
    if method == 1:
        resid = _rowpack_decode_numpy(data, 8 + 4 * ndim, shape)
    else:
        payload = zlib.decompress(data[8 + 4 * ndim :])
        dt = {1: "<u1", 2: "<u2", 4: "<u4"}[itemsize]
        zz = np.frombuffer(payload, dtype=dt).astype(np.int64).reshape(shape)
        resid = (zz >> 1) ^ -(zz & 1)
    if ndim >= 1 and shape[0] > 1:
        ticks = np.cumsum(resid, axis=0)
    else:
        ticks = resid
    out = ticks.astype(np.float64) * (2.0**tick_power)
    return out.astype(dtype if dtype is not None else np.float32)
