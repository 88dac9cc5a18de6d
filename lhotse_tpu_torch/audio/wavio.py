"""
Self-contained RIFF/WAVE codec in pure numpy (copied from
``lhotse_tpu/audio/wavio.py``): header-only ``info()`` probes and partial
reads (frame offset + count) for ``Recording.load_audio``. Sample scaling
matches libsndfile's float conversion (int16/32768, int32/2^31,
24-bit/2^23, uint8 offset-binary).

Supported: PCM 8/16/24/32-bit, IEEE float32/64, WAVE_FORMAT_EXTENSIBLE,
mu-law/A-law, IMA and MS ADPCM, RF64 (BW64) large files, non-seekable
streams (pipes).
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_MS_ADPCM = 0x0002
WAVE_FORMAT_IMA_ADPCM = 0x0011
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavFormatError(Exception):
    pass


@dataclass
class WavHeader:
    sampling_rate: int
    num_channels: int
    num_frames: int
    bits_per_sample: int
    format_tag: int
    data_offset: int
    data_size: int
    # Block-coded formats (ADPCM): bytes per block and decoded samples
    # per block; 0 for sample-coded formats.
    block_align: int = 0
    samples_per_block: int = 0
    # MS ADPCM coefficient pairs from the fmt chunk; () = the 7 built-ins.
    ms_coeffs: tuple = ()

    @property
    def is_block_coded(self) -> bool:
        return self.format_tag in (WAVE_FORMAT_IMA_ADPCM, WAVE_FORMAT_MS_ADPCM)

    @property
    def bytes_per_frame(self) -> int:
        return self.num_channels * self.bits_per_sample // 8

    @property
    def duration(self) -> float:
        return self.num_frames / self.sampling_rate


def _read_exact(f: BinaryIO, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def parse_wav_header(f: BinaryIO) -> WavHeader:
    """
    Parse the RIFF/RF64 header up to (and including) locating the 'data' chunk.
    Leaves the stream positioned at the start of the audio data.
    """
    riff = _read_exact(f, 12)
    if len(riff) < 12 or riff[:4] not in (b"RIFF", b"RF64") or riff[8:12] != b"WAVE":
        raise WavFormatError("Not a RIFF/WAVE file")
    is_rf64 = riff[:4] == b"RF64"
    rf64_data_size = None

    fmt = None
    fact_frames = None
    data_offset = None
    data_size = None
    pos = 12
    while True:
        hdr = _read_exact(f, 8)
        if len(hdr) < 8:
            break
        chunk_id, chunk_size = struct.unpack("<4sI", hdr)
        pos += 8
        if chunk_id == b"ds64":
            body = _read_exact(f, chunk_size)
            # ds64: riff_size(8) data_size(8) sample_count(8) ...
            rf64_data_size = struct.unpack("<Q", body[8:16])[0]
            pos += chunk_size
        elif chunk_id == b"fmt ":
            body = _read_exact(f, chunk_size)
            pos += chunk_size
            (format_tag, num_channels, sampling_rate, _byte_rate, block_align, bits) = struct.unpack(
                "<HHIIHH", body[:16])
            if format_tag == WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                # true format is the first 2 bytes of the SubFormat GUID
                format_tag = struct.unpack("<H", body[24:26])[0]
            samples_per_block = 0
            ms_coeffs = ()
            if format_tag == WAVE_FORMAT_IMA_ADPCM:
                if chunk_size >= 20:
                    samples_per_block = struct.unpack("<H", body[18:20])[0]
                if samples_per_block == 0:
                    samples_per_block = (block_align - 4 * num_channels) * 2 // num_channels + 1
            elif format_tag == WAVE_FORMAT_MS_ADPCM:
                if chunk_size >= 20:
                    samples_per_block = struct.unpack("<H", body[18:20])[0]
                if samples_per_block == 0:
                    samples_per_block = (block_align - 7 * num_channels) * 2 // num_channels + 2
                if chunk_size >= 22:
                    num_coef = struct.unpack("<H", body[20:22])[0]
                    if 22 + 4 * num_coef <= chunk_size:
                        ms_coeffs = tuple(
                            struct.unpack("<hh", body[22 + 4 * i : 26 + 4 * i])
                            for i in range(num_coef)
                        )
            fmt = (format_tag, num_channels, sampling_rate, bits, block_align, samples_per_block, ms_coeffs)
        elif chunk_id == b"fact":
            skip = chunk_size + (chunk_size & 1)  # chunks are word-aligned
            body = _read_exact(f, skip)
            pos += skip
            if chunk_size >= 4:
                fact_frames = struct.unpack("<I", body[:4])[0]
        elif chunk_id == b"data":
            data_offset = pos
            data_size = chunk_size
            if is_rf64 and chunk_size == 0xFFFFFFFF and rf64_data_size is not None:
                data_size = rf64_data_size
            break
        else:
            # skip unknown chunk (word-aligned)
            skip = chunk_size + (chunk_size & 1)
            try:
                f.seek(skip, io.SEEK_CUR)
            except (OSError, io.UnsupportedOperation):
                _read_exact(f, skip)
            pos += skip
    if fmt is None or data_offset is None:
        raise WavFormatError("Missing fmt or data chunk in WAVE file")
    format_tag, num_channels, sampling_rate, bits, block_align, samples_per_block, ms_coeffs = fmt
    if format_tag in (WAVE_FORMAT_IMA_ADPCM, WAVE_FORMAT_MS_ADPCM):
        num_blocks = data_size // block_align if block_align else 0
        num_frames = num_blocks * samples_per_block
        if fact_frames:  # 0 = broken encoder artifact; ignore
            num_frames = min(num_frames, fact_frames)
        return WavHeader(
            sampling_rate=sampling_rate, num_channels=num_channels, num_frames=num_frames,
            bits_per_sample=bits, format_tag=format_tag, data_offset=data_offset,
            data_size=data_size, block_align=block_align, samples_per_block=samples_per_block,
            ms_coeffs=ms_coeffs)
    bytes_per_frame = num_channels * bits // 8
    if bytes_per_frame == 0:
        raise WavFormatError("Invalid WAVE header (zero frame size)")
    num_frames = data_size // bytes_per_frame
    if fact_frames and format_tag not in (WAVE_FORMAT_PCM, WAVE_FORMAT_IEEE_FLOAT):
        num_frames = min(num_frames, fact_frames)
    return WavHeader(
        sampling_rate=sampling_rate, num_channels=num_channels, num_frames=num_frames,
        bits_per_sample=bits, format_tag=format_tag, data_offset=data_offset,
        data_size=data_size, block_align=block_align)


# mu-law / A-law decode tables (ITU-T G.711), computed once.
def _make_mulaw_table() -> np.ndarray:
    u = np.arange(256, dtype=np.int64)
    u = ~u & 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    magnitude = ((mantissa << 3) + 0x84) << exponent
    magnitude = magnitude - 0x84
    out = np.where(sign != 0, -magnitude, magnitude)
    return (out.astype(np.float32)) / 32768.0


def _make_alaw_table() -> np.ndarray:
    a = np.arange(256, dtype=np.int64) ^ 0x55
    sign = a & 0x80
    exponent = (a >> 4) & 0x07
    mantissa = a & 0x0F
    magnitude = np.where(
        exponent > 0, ((mantissa << 4) + 0x108) << (exponent - 1), (mantissa << 4) + 8)
    out = np.where(sign != 0, -magnitude, magnitude)
    return (out.astype(np.float32)) / 32768.0


_MULAW_TABLE: Optional[np.ndarray] = None
_ALAW_TABLE: Optional[np.ndarray] = None


def mulaw_table() -> np.ndarray:
    """256-entry mu-law byte -> float32 decode table (shared by codecs)."""
    global _MULAW_TABLE
    if _MULAW_TABLE is None:
        _MULAW_TABLE = _make_mulaw_table()
    return _MULAW_TABLE


def alaw_table() -> np.ndarray:
    """256-entry A-law byte -> float32 decode table (shared by codecs)."""
    global _ALAW_TABLE
    if _ALAW_TABLE is None:
        _ALAW_TABLE = _make_alaw_table()
    return _ALAW_TABLE


def _decode_frames(raw: bytes, header: WavHeader) -> np.ndarray:
    """Decode raw interleaved frames to float32 (num_channels, num_frames)."""
    global _MULAW_TABLE, _ALAW_TABLE
    bits = header.bits_per_sample
    tag = header.format_tag
    C = header.num_channels
    n_frames = len(raw) // header.bytes_per_frame
    raw = raw[: n_frames * header.bytes_per_frame]
    if tag == WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        else:
            raise WavFormatError(f"Unsupported PCM bit depth: {bits}")
    elif tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise WavFormatError(f"Unsupported float bit depth: {bits}")
    elif tag == WAVE_FORMAT_MULAW:
        if _MULAW_TABLE is None:
            _MULAW_TABLE = _make_mulaw_table()
        x = _MULAW_TABLE[np.frombuffer(raw, dtype=np.uint8)]
    elif tag == WAVE_FORMAT_ALAW:
        if _ALAW_TABLE is None:
            _ALAW_TABLE = _make_alaw_table()
        x = _ALAW_TABLE[np.frombuffer(raw, dtype=np.uint8)]
    else:
        raise WavFormatError(f"Unsupported WAVE format tag: 0x{tag:04x}")
    return np.ascontiguousarray(x.reshape(n_frames, C).T)


# -- IMA ADPCM (DVI4, format tag 0x0011) --------------------------------------
#
# Block-coded 4-bit predictive format: each block carries per-channel
# (predictor, step index) headers followed by nibbles in 4-byte per-channel
# groups, low nibble first. The sample recurrence is sequential, but decoding
# vectorizes across blocks and channels: the loop below runs samples-per-block
# (~505) numpy steps regardless of file length.

_IMA_INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8] * 2, dtype=np.int32)
_IMA_STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17,
    19, 21, 23, 25, 28, 31, 34, 37, 41, 45,
    50, 55, 60, 66, 73, 80, 88, 97, 107, 118,
    130, 143, 157, 173, 190, 209, 230, 253, 279, 307,
    337, 371, 408, 449, 494, 544, 598, 658, 724, 796,
    876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358,
    5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
], dtype=np.int32)


def _decode_ima_adpcm_blocks(raw: bytes, header: WavHeader) -> np.ndarray:
    """Whole blocks -> (num_channels, num_blocks * samples_per_block) f32."""
    C, ba, spb = header.num_channels, header.block_align, header.samples_per_block
    B = len(raw) // ba
    if B == 0:
        return np.zeros((C, 0), dtype=np.float32)
    data = np.frombuffer(raw, dtype=np.uint8)[: B * ba].reshape(B, ba)

    hdr = data[:, : 4 * C].reshape(B, C, 4).astype(np.int32)
    predictor = (hdr[:, :, 0] | (hdr[:, :, 1] << 8)).astype(np.int32)
    predictor = (predictor << 16) >> 16  # sign-extend int16
    index = np.clip(hdr[:, :, 2], 0, 88)

    out = np.empty((B, C, spb), dtype=np.int32)
    out[:, :, 0] = predictor

    groups = data[:, 4 * C :].reshape(B, -1, C, 4)  # (B, G, C, 4)
    low, high = groups & 0x0F, groups >> 4
    # Sample order inside a 4-byte group: b0.low, b0.high, b1.low, ...
    nibbles = np.stack([low, high], axis=-1).reshape(B, groups.shape[1], C, 8)
    nibbles = nibbles.transpose(0, 2, 1, 3).reshape(B, C, -1)[:, :, : spb - 1]

    step = _IMA_STEP_TABLE[index]
    pred = predictor
    for t in range(spb - 1):
        n = nibbles[:, :, t]
        diff = (
            (step >> 3)
            + np.where(n & 1, step >> 2, 0)
            + np.where(n & 2, step >> 1, 0)
            + np.where(n & 4, step, 0)
        )
        pred = np.where(n & 8, pred - diff, pred + diff)
        pred = np.clip(pred, -32768, 32767)
        index = np.clip(index + _IMA_INDEX_TABLE[n], 0, 88)
        step = _IMA_STEP_TABLE[index]
        out[:, :, t + 1] = pred

    return out.transpose(1, 0, 2).reshape(C, -1).astype(np.float32) / 32768.0


# -- Microsoft ADPCM (format tag 0x0002) --------------------------------------

_MS_ADAPTATION = np.array(
    [230, 230, 230, 230, 307, 409, 512, 614, 768, 614, 512, 409, 307, 230, 230, 230],
    dtype=np.int64)
_MS_COEF1 = np.array([256, 512, 0, 192, 240, 460, 392], dtype=np.int64)
_MS_COEF2 = np.array([0, -256, 0, 64, 0, -208, -232], dtype=np.int64)


def _decode_ms_adpcm_blocks(raw: bytes, header: WavHeader) -> np.ndarray:
    """Whole blocks -> (num_channels, num_blocks * samples_per_block) f32."""
    C, ba, spb = header.num_channels, header.block_align, header.samples_per_block
    B = len(raw) // ba
    if B == 0:
        return np.zeros((C, 0), dtype=np.float32)
    data = np.frombuffer(raw, dtype=np.uint8)[: B * ba].reshape(B, ba)

    if header.ms_coeffs:
        coef1_tab = np.array([c[0] for c in header.ms_coeffs], dtype=np.int64)
        coef2_tab = np.array([c[1] for c in header.ms_coeffs], dtype=np.int64)
    else:
        coef1_tab, coef2_tab = _MS_COEF1, _MS_COEF2
    # Per-channel headers, channel-interleaved field by field:
    # bpred[C] | idelta[C] i16 | sample1[C] i16 | sample2[C] i16
    bpred = data[:, :C].astype(np.int64)
    if bpred.max(initial=0) >= len(coef1_tab):
        raise WavFormatError(
            f"MS ADPCM block predictor {int(bpred.max())} out of range for "
            f"{len(coef1_tab)} coefficient pairs."
        )

    def i16(lo, hi):
        v = lo.astype(np.int64) | (hi.astype(np.int64) << 8)
        return (v.astype(np.int32) << 16) >> 16

    off = C
    idelta = i16(data[:, off : off + 2 * C : 2], data[:, off + 1 : off + 2 * C : 2]).astype(np.int64)
    off += 2 * C
    sample1 = i16(data[:, off : off + 2 * C : 2], data[:, off + 1 : off + 2 * C : 2]).astype(np.int64)
    off += 2 * C
    sample2 = i16(data[:, off : off + 2 * C : 2], data[:, off + 1 : off + 2 * C : 2]).astype(np.int64)
    off += 2 * C

    coef1, coef2 = coef1_tab[bpred], coef2_tab[bpred]

    out = np.empty((B, C, spb), dtype=np.int64)
    out[:, :, 0] = sample2  # the older sample plays first
    out[:, :, 1] = sample1

    payload = data[:, off:]
    # MS nibble order: HIGH nibble first; channels alternate nibble by nibble.
    nib = np.stack([payload >> 4, payload & 0x0F], axis=-1).reshape(B, -1)
    nib = nib[:, : (spb - 2) * C].reshape(B, spb - 2, C).transpose(0, 2, 1)
    signed = nib.astype(np.int64)
    signed = np.where(signed >= 8, signed - 16, signed)

    for t in range(spb - 2):
        # MS spec divides by 256 with C semantics (truncation toward zero);
        # '>> 8' would floor, decoding negative sums 1 LSB low and feeding
        # the error back through the recurrence.
        acc = sample1 * coef1 + sample2 * coef2
        pred = (acc + (acc < 0) * 255) >> 8
        pred = pred + signed[:, :, t] * idelta
        pred = np.clip(pred, -32768, 32767)
        sample2, sample1 = sample1, pred
        idelta = np.maximum((_MS_ADAPTATION[nib[:, :, t]] * idelta) >> 8, 16)
        out[:, :, t + 2] = pred

    return out.transpose(1, 0, 2).reshape(C, -1).astype(np.float32) / 32768.0


def _read_block_coded(f: BinaryIO, header: WavHeader, frame_offset: int, count: int) -> np.ndarray:
    """Partial read of a block-coded stream: decode the covering blocks."""
    spb = header.samples_per_block
    first_block = frame_offset // spb
    last_block = (frame_offset + count + spb - 1) // spb if count else first_block
    start_byte = first_block * header.block_align
    try:
        f.seek(header.data_offset + start_byte)
    except (OSError, io.UnsupportedOperation):
        _read_exact(f, start_byte)
    raw = _read_exact(f, (last_block - first_block) * header.block_align)
    if header.format_tag == WAVE_FORMAT_MS_ADPCM:
        decoded = _decode_ms_adpcm_blocks(raw, header)
    else:
        decoded = _decode_ima_adpcm_blocks(raw, header)
    lo = frame_offset - first_block * spb
    return np.ascontiguousarray(decoded[:, lo : lo + count])


def read_wav(
    source: Union[str, BinaryIO], frame_offset: int = 0, num_frames: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """
    Read a WAV file (or file-like object) returning
    ``(samples(channels, frames) float32, sampling_rate)``.
    Partial reads seek directly to the requested frame range when the
    underlying stream is seekable; otherwise the preceding bytes are consumed.
    """
    close = False
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        f = open(source, "rb")
        close = True
    else:
        f = source
    try:
        header = parse_wav_header(f)
        if header.is_block_coded:
            if num_frames is None:
                count = header.num_frames - frame_offset
            else:
                count = min(num_frames, max(header.num_frames - frame_offset, 0))
            return _read_block_coded(f, header, frame_offset, max(count, 0)), header.sampling_rate
        start_byte = frame_offset * header.bytes_per_frame
        if num_frames is None:
            count = header.num_frames - frame_offset
        else:
            count = min(num_frames, max(header.num_frames - frame_offset, 0))
        count = max(count, 0)
        try:
            f.seek(header.data_offset + start_byte)
        except (OSError, io.UnsupportedOperation):
            _read_exact(f, start_byte)
        raw = _read_exact(f, count * header.bytes_per_frame)
        return _decode_frames(raw, header), header.sampling_rate
    finally:
        if close:
            f.close()


def info_wav(source: Union[str, BinaryIO]) -> WavHeader:
    close = False
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        f = open(source, "rb")
        close = True
    else:
        f = source
    try:
        pos = None
        if f.seekable():
            pos = f.tell()
        header = parse_wav_header(f)
        if pos is not None:
            f.seek(pos)
        return header
    finally:
        if close:
            f.close()


def write_wav(
    dest: Union[str, BinaryIO], samples: np.ndarray, sampling_rate: int, subtype: str = "pcm16",
) -> None:
    """
    Write samples to a WAV file. ``samples`` may be (frames,), (channels,
    frames), or (frames, channels) — 2-D inputs with fewer rows than columns
    are treated as channel-major, matching this library's convention.

    :param subtype: "pcm16", "pcm24", "pcm32", "float32", or "float64".
    """
    samples = np.asarray(samples)
    if samples.ndim == 1:
        frames = samples[:, None]
    elif samples.shape[0] <= samples.shape[1]:
        frames = samples.T  # (channels, frames) -> (frames, channels)
    else:
        frames = samples
    num_frames, num_channels = frames.shape

    if subtype == "pcm16":
        data = (
            np.clip(np.rint(frames.astype(np.float64) * 32768.0), -32768, 32767)
            .astype("<i2")
            .tobytes()
        )
        bits, tag = 16, WAVE_FORMAT_PCM
    elif subtype == "pcm32":
        data = (
            np.clip(
                np.rint(frames.astype(np.float64) * 2147483648.0),
                -2147483648,
                2147483647,
            )
            .astype("<i4")
            .tobytes()
        )
        bits, tag = 32, WAVE_FORMAT_PCM
    elif subtype == "pcm24":
        x = np.clip(
            np.rint(frames.astype(np.float64) * float(1 << 23)), -(1 << 23), (1 << 23) - 1,
        ).astype(np.int32)
        b = np.empty((x.size, 3), dtype=np.uint8)
        flat = x.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        data = b.tobytes()
        bits, tag = 24, WAVE_FORMAT_PCM
    elif subtype == "float32":
        data = frames.astype("<f4").tobytes()
        bits, tag = 32, WAVE_FORMAT_IEEE_FLOAT
    elif subtype == "float64":
        data = frames.astype("<f8").tobytes()
        bits, tag = 64, WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"Unsupported WAV subtype: {subtype}")

    byte_rate = sampling_rate * num_channels * bits // 8
    block_align = num_channels * bits // 8
    fmt_chunk = struct.pack(
        "<4sIHHIIHH", b"fmt ", 16, tag, num_channels, sampling_rate, byte_rate, block_align, bits)
    data_hdr = struct.pack("<4sI", b"data", len(data))
    riff_size = 4 + len(fmt_chunk) + len(data_hdr) + len(data)
    header = struct.pack("<4sI4s", b"RIFF", riff_size, b"WAVE")

    close = False
    if isinstance(dest, (str, bytes)) or hasattr(dest, "__fspath__"):
        f = open(dest, "wb")
        close = True
    else:
        f = dest
    try:
        f.write(header)
        f.write(fmt_chunk)
        f.write(data_hdr)
        f.write(data)
        if len(data) & 1:
            f.write(b"\x00")
    finally:
        if close:
            f.close()
