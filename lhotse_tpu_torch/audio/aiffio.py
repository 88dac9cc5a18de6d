"""
Native AIFF / AIFF-C reader + writer (copied from
``lhotse_tpu/audio/aiffio.py``; pure numpy, no external audio libraries).
It covers the common profiles:

- AIFF: big-endian PCM 8/16/24/32-bit
- AIFF-C compression types: ``NONE`` (BE PCM), ``sowt`` (LE PCM),
  ``fl32``/``FL32`` (float32), ``fl64`` (float64), ``ulaw``/``ULAW``,
  ``alaw``/``ALAW``
- Writer emits standard AIFF PCM16 (big-endian).

File layout: an IFF ``FORM`` container with ``COMM`` (channels, frame count,
sample width, sample rate as an 80-bit IEEE-754 extended float) and ``SSND``
(offset, block size, interleaved samples) chunks.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from io import BytesIO
from pathlib import Path
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

from lhotse_tpu_torch.audio.wavio import alaw_table, mulaw_table


@dataclass
class AiffInfo:
    num_channels: int
    sampling_rate: int
    bits_per_sample: int
    num_frames: int
    compression: str  # 4cc, 'NONE' for plain AIFF


def _read_extended80(b: bytes) -> float:
    """Decode an 80-bit IEEE-754 extended float (AIFF sample rate field)."""
    (se, hi, lo) = struct.unpack(">HII", b)
    sign = -1.0 if se & 0x8000 else 1.0
    exponent = se & 0x7FFF
    mantissa = (hi << 32) | lo
    if exponent == 0 and mantissa == 0:
        return 0.0
    if exponent == 0x7FFF:
        return float("nan")
    return sign * mantissa * 2.0 ** (exponent - 16383 - 63)


def _write_extended80(value: float) -> bytes:
    if value == 0:
        return b"\x00" * 10
    sign = 0x8000 if value < 0 else 0
    value = abs(value)
    exponent = 16383 + 63
    mantissa = int(value)
    frac = value - mantissa
    # Normalize: shift mantissa so bit 63 is set.
    while mantissa < (1 << 63):
        mantissa <<= 1
        frac *= 2.0
        whole = int(frac)
        mantissa |= whole
        frac -= whole
        exponent -= 1
    while mantissa >= (1 << 64):
        mantissa >>= 1
        exponent += 1
    return struct.pack(">HII", sign | exponent, (mantissa >> 32) & 0xFFFFFFFF, mantissa & 0xFFFFFFFF)


def _open(src: Union[str, Path, bytes, BinaryIO]) -> BinaryIO:
    if isinstance(src, bytes):
        return BytesIO(src)
    if isinstance(src, (str, Path)):
        return open(src, "rb")
    return src


def _parse(f: BinaryIO) -> Tuple[AiffInfo, int, int]:
    """Returns (info, ssnd_data_offset, ssnd_data_size)."""
    magic = f.read(12)
    if len(magic) < 12 or magic[:4] != b"FORM" or magic[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("Not an AIFF/AIFF-C stream (missing FORM/AIFF header).")
    is_aifc = magic[8:12] == b"AIFC"
    comm = None
    compression = "NONE"
    ssnd_off = ssnd_size = None
    while True:
        head = f.read(8)
        if len(head) < 8:
            break
        cid, size = head[:4], struct.unpack(">I", head[4:])[0]
        payload_pos = f.tell()
        if cid == b"COMM":
            body = f.read(size)
            channels, frames, bits = struct.unpack(">HIH", body[:8])
            rate = _read_extended80(body[8:18])
            if is_aifc and size >= 22:
                compression = body[18:22].decode("latin1")
            comm = (channels, frames, bits, rate)
        elif cid == b"SSND":
            body8 = f.read(8)
            offset, _blocksize = struct.unpack(">II", body8)
            ssnd_off = payload_pos + 8 + offset
            ssnd_size = size - 8 - offset
        # Chunks are word-aligned (pad byte after odd sizes).
        f.seek(payload_pos + size + (size & 1))
    if comm is None:
        raise ValueError("AIFF stream has no COMM chunk.")
    channels, frames, bits, rate = comm
    if ssnd_off is None:
        if frames != 0:
            raise ValueError("AIFF stream has no SSND chunk but claims frames.")
        ssnd_off, ssnd_size = 0, 0
    info = AiffInfo(
        num_channels=channels, sampling_rate=int(round(rate)),
        bits_per_sample=bits, num_frames=frames, compression=compression)
    return info, ssnd_off, ssnd_size


def info_aiff(src) -> AiffInfo:
    f = _open(src)
    try:
        return _parse(f)[0]
    finally:
        if isinstance(src, (str, Path, bytes)):  # _open created the stream
            f.close()


def read_aiff(src) -> Tuple[np.ndarray, int]:
    """Decode AIFF/AIFF-C → ((channels, frames) float32 in [-1, 1], rate)."""
    f = _open(src)
    try:
        info, off, size = _parse(f)
        f.seek(off)
        raw = f.read(size)
    finally:
        if isinstance(src, (str, Path, bytes)):
            f.close()

    ch, bits = info.num_channels, info.bits_per_sample
    comp = info.compression.strip().upper()
    # 'twos' = big-endian PCM (legacy Mac tools emit it; libsndfile reads it
    # identically to uncompressed AIFF-C).
    if comp in ("NONE", "SOWT", "TWOS"):
        endian = "<" if comp == "SOWT" else ">"
        if bits == 16:
            x = np.frombuffer(raw, dtype=endian + "i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            if endian == ">":
                vals = (
                    (b[:, 0].astype(np.int32) << 16)
                    | (b[:, 1].astype(np.int32) << 8)
                    | b[:, 2].astype(np.int32)
                )
            else:
                vals = (
                    (b[:, 2].astype(np.int32) << 16)
                    | (b[:, 1].astype(np.int32) << 8)
                    | b[:, 0].astype(np.int32)
                )
            vals = (vals << 8) >> 8  # sign-extend from 24 bits
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype=endian + "i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"Unsupported AIFF PCM width: {bits} bits.")
    elif comp == "FL32":
        x = np.frombuffer(raw, dtype=">f4").astype(np.float32)
    elif comp == "FL64":
        x = np.frombuffer(raw, dtype=">f8").astype(np.float32)
    elif comp == "ULAW":
        x = mulaw_table()[np.frombuffer(raw, dtype=np.uint8)]
    elif comp == "ALAW":
        x = alaw_table()[np.frombuffer(raw, dtype=np.uint8)]
    else:
        raise ValueError(f"Unsupported AIFF-C compression type: '{info.compression}'.")

    frames = x.size // ch
    return x[: frames * ch].reshape(frames, ch).T, info.sampling_rate


def write_aiff(
    dest: Union[str, Path, BinaryIO], samples: np.ndarray, sampling_rate: int) -> None:
    """Encode float samples ((channels, frames) or (frames,)) as AIFF PCM16."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    ch, frames = samples.shape
    if np.issubdtype(samples.dtype, np.floating):
        pcm = np.clip(np.rint(samples * 32768.0), -32768, 32767).astype(">i2")
    else:
        pcm = samples.astype(">i2")
    data = np.ascontiguousarray(pcm.T).tobytes()

    comm = struct.pack(">HIH", ch, frames, 16) + _write_extended80(float(sampling_rate))
    ssnd = struct.pack(">II", 0, 0) + data
    chunks = b"".join(
        cid + struct.pack(">I", len(body)) + body + (b"\x00" if len(body) & 1 else b"")
        for cid, body in ((b"COMM", comm), (b"SSND", ssnd))
    )
    form = b"AIFF" + chunks
    blob = b"FORM" + struct.pack(">I", len(form)) + form
    if isinstance(dest, (str, Path)):
        with open(dest, "wb") as f:
            f.write(blob)
    else:
        dest.write(blob)
