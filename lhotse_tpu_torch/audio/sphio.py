"""
Native NIST SPHERE (.sph/.wv1/.wv2) codec (copied from
``lhotse_tpu/audio/sphio.py``): pure numpy, no ``sph2pipe``.

It decodes the uncompressed codings (PCM 8/16/24/32-bit in either byte
order, G.711 mu-law and A-law) directly, with header-only probing and
seek-based partial reads. Shorten-embedded files still require
``sph2pipe``: they raise a targeted error so the composite backend can fall
through to the subprocess backend when the binary exists.

Format: an ASCII header starting with ``NIST_1A\n<header_bytes>\n`` followed
by ``name -type value`` lines until ``end_head``; sample data begins at byte
``header_bytes``.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from lhotse_tpu_torch.audio.utils import AudioLoadingError
from lhotse_tpu_torch.utils import Pathlike

SPHERE_MAGIC = b"NIST_1A"


class SphereFormatError(AudioLoadingError):
    pass


class SphereShortenError(SphereFormatError):
    """The file uses embedded-shorten compression, which needs ``sph2pipe``."""


@dataclass
class SphereInfo:
    sample_count: int
    num_channels: int
    sampling_rate: int
    sample_n_bytes: int
    coding: str          # "pcm" | "ulaw" | "alaw" | "shorten"
    big_endian: bool
    data_offset: int     # byte offset where samples start
    interleaved: bool = True

    @property
    def duration(self) -> float:
        return self.sample_count / self.sampling_rate


def _parse_header(head: bytes) -> SphereInfo:
    fields = {}
    for raw_line in head.split(b"\n"):
        line = raw_line.strip()
        if not line or line.startswith(b";"):
            continue
        if line == b"end_head":
            break
        parts = line.split(None, 2)
        if len(parts) != 3:
            continue
        name, ftype, value = parts
        key = name.decode("ascii", errors="replace")
        if ftype == b"-i":
            fields[key] = int(value)
        elif ftype == b"-r":
            fields[key] = float(value)
        else:  # -sN string
            fields[key] = value.decode("ascii", errors="replace")
    try:
        n_bytes = int(fields.get("sample_n_bytes", 2))
        channels = int(fields.get("channel_count", 1))
        rate = int(fields["sample_rate"])
        count = int(fields["sample_count"])
    except KeyError as e:
        raise SphereFormatError(f"SPHERE header is missing required field {e}.")

    coding = str(fields.get("sample_coding", "pcm")).lower()
    if "shorten" in coding:
        base = "shorten"
    elif "ulaw" in coding or "mu-law" in coding or "mulaw" in coding:
        base = "ulaw"
        n_bytes = 1
    elif "alaw" in coding:
        base = "alaw"
        n_bytes = 1
    elif "pcm" in coding:
        base = "pcm"
    else:
        raise SphereFormatError(f"Unsupported SPHERE sample_coding: {coding!r}.")

    byte_fmt = str(fields.get("sample_byte_format", "01"))
    big_endian = byte_fmt.startswith("10")
    if "shortpack" in byte_fmt:
        raise SphereFormatError("shortpack-compressed SPHERE files are not supported.")

    return SphereInfo(
        sample_count=count, num_channels=channels, sampling_rate=rate,
        sample_n_bytes=n_bytes, coding=base, big_endian=big_endian,
        data_offset=0)


def _read_header(f) -> SphereInfo:
    start = f.read(16)
    if not start.startswith(SPHERE_MAGIC):
        raise SphereFormatError("Not a SPHERE file (missing NIST_1A magic).")
    try:
        header_size = int(start[8:16].split(b"\n", 1)[0].strip())
    except ValueError:
        raise SphereFormatError("Malformed SPHERE header-size line.")
    head = start + f.read(max(header_size - 16, 0))
    info = _parse_header(head[:header_size])
    info.data_offset = header_size
    return info


# --- G.711 companding ------------------------------------------------------

def _ulaw_decode_table() -> np.ndarray:
    u = np.arange(256, dtype=np.uint16) ^ 0xFF  # one's complement
    mantissa = (u & 0x0F).astype(np.int32)
    exponent = ((u >> 4) & 0x07).astype(np.int32)
    magnitude = (((mantissa << 3) + 0x84) << exponent) - 0x84
    sample = np.where(u & 0x80, -magnitude, magnitude)
    return sample.astype(np.int16)


def _alaw_decode_table() -> np.ndarray:
    a = np.arange(256, dtype=np.uint16) ^ 0x55
    mantissa = (a & 0x0F).astype(np.int32)
    exponent = ((a >> 4) & 0x07).astype(np.int32)
    magnitude = np.where(
        exponent == 0, (mantissa << 4) + 8,
        ((mantissa << 4) + 0x108) << np.maximum(exponent - 1, 0))
    # The formula above already lands on the 16-bit scale (max 32256 = 4032<<3).
    sample = np.where(a & 0x80, magnitude, -magnitude)
    return sample.astype(np.int16)


_ULAW_TABLE = _ulaw_decode_table()
_ALAW_TABLE = _alaw_decode_table()


def _ulaw_encode(x16: np.ndarray) -> np.ndarray:
    """Encode int16 samples to G.711 mu-law bytes (for round-trip tests and
    writing telephone-rate fixtures)."""
    x = x16.astype(np.int32)
    sign = np.where(x < 0, 0x80, 0).astype(np.int32)
    mag = np.minimum(np.abs(x), 32635) + 0x84
    exponent = (np.floor(np.log2(mag)) - 7).astype(np.int32)
    exponent = np.clip(exponent, 0, 7)
    mantissa = (mag >> (exponent + 3)) & 0x0F
    return ((sign | (exponent << 4) | mantissa) ^ 0xFF).astype(np.uint8)


def _alaw_encode(x16: np.ndarray) -> np.ndarray:
    x = (x16.astype(np.int32)) >> 3  # 16-bit -> 13-bit
    sign = np.where(x >= 0, 0x80, 0).astype(np.int32)
    mag = np.minimum(np.abs(x), 0xFFF)
    exponent = np.maximum((np.floor(np.log2(np.maximum(mag, 1))) - 4), 0).astype(np.int32)
    mantissa = np.where(exponent == 0, mag >> 1, (mag >> exponent) & 0x0F)
    return ((sign | (exponent << 4) | mantissa) ^ 0x55).astype(np.uint8)


# --- public API -------------------------------------------------------------

def info_sph(path_or_fd: Union[Pathlike, "FileObject"]) -> SphereInfo:
    """Header-only probe of a SPHERE file."""
    if isinstance(path_or_fd, (str, Path)):
        with open(path_or_fd, "rb") as f:
            return _read_header(f)
    pos = path_or_fd.tell()
    try:
        return _read_header(path_or_fd)
    finally:
        path_or_fd.seek(pos)


def read_sph(
    path_or_fd: Union[Pathlike, "FileObject"],
    frame_offset: int = 0,
    num_frames: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """
    Decode a SPHERE file to ``(samples(channels, frames) float32 in [-1, 1],
    sampling_rate)``.  Partial reads seek directly to the requested frames.
    """
    if isinstance(path_or_fd, (str, Path)):
        f = open(path_or_fd, "rb")
        close = True
    else:
        f = path_or_fd
        close = False
    try:
        hdr = _read_header(f)
        if hdr.coding == "shorten":
            raise SphereShortenError(
                "This SPHERE file is embedded-shorten compressed; decoding it "
                "requires the 'sph2pipe' binary on PATH.")
        frames_total = hdr.sample_count
        lo = min(max(frame_offset, 0), frames_total)
        hi = frames_total if num_frames is None else min(lo + num_frames, frames_total)
        n = max(hi - lo, 0)
        frame_bytes = hdr.sample_n_bytes * hdr.num_channels
        f.seek(hdr.data_offset + lo * frame_bytes)
        raw = f.read(n * frame_bytes)
        if len(raw) < n * frame_bytes:
            raise SphereFormatError(
                f"SPHERE file truncated: wanted {n * frame_bytes} bytes at frame "
                f"{lo}, got {len(raw)}.")
        order = ">" if hdr.big_endian else "<"
        if hdr.coding == "ulaw":
            x = _ULAW_TABLE[np.frombuffer(raw, dtype=np.uint8)].astype(np.float32) / 32768.0
        elif hdr.coding == "alaw":
            x = _ALAW_TABLE[np.frombuffer(raw, dtype=np.uint8)].astype(np.float32) / 32768.0
        elif hdr.sample_n_bytes == 2:
            x = np.frombuffer(raw, dtype=f"{order}i2").astype(np.float32) / 32768.0
        elif hdr.sample_n_bytes == 1:
            # 1-byte PCM in SPHERE is signed
            x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
        elif hdr.sample_n_bytes == 4:
            x = np.frombuffer(raw, dtype=f"{order}i4").astype(np.float32) / 2147483648.0
        elif hdr.sample_n_bytes == 3:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.uint32)
            if hdr.big_endian:
                v = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
            else:
                v = (b[:, 2] << 16) | (b[:, 1] << 8) | b[:, 0]
            v = np.where(v >= 1 << 23, v.astype(np.int64) - (1 << 24), v.astype(np.int64))
            x = v.astype(np.float32) / float(1 << 23)
        else:
            raise SphereFormatError(
                f"Unsupported SPHERE sample width: {hdr.sample_n_bytes} bytes.")
        return np.ascontiguousarray(x.reshape(n, hdr.num_channels).T), hdr.sampling_rate
    finally:
        if close:
            f.close()


def write_sph(
    dest: Union[Pathlike, "FileObject"],
    samples: np.ndarray,
    sampling_rate: int,
    coding: str = "pcm16",
    big_endian: bool = False,
) -> None:
    """
    Write ``samples`` (``(channels, frames)`` float32 in [-1, 1] or int16) as
    a SPHERE file.  ``coding``: ``pcm16`` | ``ulaw`` | ``alaw``.
    """
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, frames = samples.shape
    if samples.dtype != np.int16:
        x16 = np.clip(np.round(samples.astype(np.float64) * 32768.0), -32768, 32767)
        x16 = x16.astype(np.int16)
    else:
        x16 = samples
    interleaved = np.ascontiguousarray(x16.T)  # (frames, channels)

    if coding == "pcm16":
        payload = interleaved.astype(">i2" if big_endian else "<i2").tobytes()
        n_bytes, coding_field = 2, "pcm"
        byte_fmt = "10" if big_endian else "01"
    elif coding == "ulaw":
        payload = _ulaw_encode(interleaved.ravel()).tobytes()
        n_bytes, coding_field, byte_fmt = 1, "ulaw", "1"
    elif coding == "alaw":
        payload = _alaw_encode(interleaved.ravel()).tobytes()
        n_bytes, coding_field, byte_fmt = 1, "alaw", "1"
    else:
        raise ValueError(f"Unsupported SPHERE write coding: {coding!r}")

    lines = [
        f"sample_count -i {frames}",
        f"sample_n_bytes -i {n_bytes}",
        f"channel_count -i {channels}",
        f"sample_byte_format -s{len(byte_fmt)} {byte_fmt}",
        f"sample_rate -i {sampling_rate}",
        f"sample_coding -s{len(coding_field)} {coding_field}",
        "end_head",
    ]
    body = "\n".join(lines).encode("ascii") + b"\n"
    header = b"NIST_1A\n" + b"   1024\n" + body
    header = header + b"\x00" * (1024 - len(header))
    if isinstance(dest, (str, Path)):
        with open(dest, "wb") as f:
            f.write(header)
            f.write(payload)
    else:
        dest.write(header)
        dest.write(payload)
