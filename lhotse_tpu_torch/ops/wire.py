"""
Wire formats for host→device audio transfer (port of ``lhotse_tpu/ops/wire.py``).

- ``float32`` — lossless, 4 B/sample;
- ``int16``  — linear PCM, 2 B/sample; decode is bit-exact with the JAX package;
- ``mulaw``  — 8-bit mu-law companding (mu=255), 1 B/sample, lossy;
- ``adpcm4`` — 4-bit IMA-style block ADPCM, ~0.56 B/sample (64-sample
  blocks, a 4-byte header each), lossy. Blocks are independent, so the
  device decode is a 64-step recurrence of elementwise int32 tensor ops over
  (batch x blocks) lanes, bit-exact against :func:`adpcm4_decode_np` and the
  JAX package's decode. Needs T to be a multiple of 64.

Encoding runs on the host: the mu-law and adpcm4 encoders take the C
encoders of :mod:`lhotse_tpu_torch.ops.host_dsp`, as the JAX package does
when its native library is built; their numpy versions (``_mulaw_encode_np``,
``_adpcm4_encode_np``) stay as the plain versions the tests hold the C
encoders to. Decoding is tensor math on the device of the wire tensor.
"""
from __future__ import annotations

import numpy as np
import torch

WIRE_FORMATS = ("float32", "int16", "mulaw", "adpcm4")
_MU = 255.0


def _mulaw_formula(x: np.ndarray) -> np.ndarray:
    """The continuous G.711-curve byte mapping."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    # [-1, 1] -> [0, 255] with 128 = zero.
    return np.clip((y + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


_MULAW_LUT = _mulaw_formula((np.arange(65536, dtype=np.float32) - 32768.0) / 32768.0)


def _mulaw_encode(x: np.ndarray) -> np.ndarray:
    """Mu-law encode via int16 pre-quantization + a 65536-entry LUT built from
    the continuous formula, in the native one-pass kernel."""
    from lhotse_tpu_torch.ops import host_dsp

    return host_dsp.mulaw_encode_lut(x, _MULAW_LUT)


def _mulaw_encode_np(x: np.ndarray) -> np.ndarray:
    """The numpy version of :func:`_mulaw_encode`."""
    q = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int32)
    return _MULAW_LUT[q + 32768]


# ---------------------------------------------------------------------------
# 4-bit block ADPCM (IMA step/index tables; independent 64-sample blocks).
# ---------------------------------------------------------------------------
ADPCM_BLOCK = 64
_ADPCM_HEADER_BYTES = 4  # pred0 (int16 LE) + step index (u8) + reserved
# The standard 89-entry IMA ADPCM step-size table.
_IMA_STEPS = np.array(
    [
        7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
        41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
        190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
        724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
        2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
        6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
        16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
    ],
    dtype=np.int32,
)
# Index adjustment by nibble magnitude (code & 7).
_IMA_INDEX = np.array([-1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)


def _adpcm4_geometry(num_samples: int):
    if num_samples % ADPCM_BLOCK:
        raise ValueError(
            f"adpcm4 wire format needs T % {ADPCM_BLOCK} == 0, got T="
            f"{num_samples} — pad the bucket shape up to a block multiple"
        )
    nb = num_samples // ADPCM_BLOCK
    return nb, nb * _ADPCM_HEADER_BYTES + num_samples // 2


def _adpcm4_encode(audio: np.ndarray) -> np.ndarray:
    """float32 ``(..., T)`` in [-1, 1] -> uint8 ``(..., W)`` wire rows:
    per row ``[nb*4 header bytes | T/2 nibble bytes]``, in the native C
    encoder (bit-exact vs :func:`_adpcm4_encode_np`)."""
    from lhotse_tpu_torch.ops import host_dsp

    T = audio.shape[-1]
    _, width = _adpcm4_geometry(T)
    return host_dsp.adpcm4_encode(np.asarray(audio, np.float32), T, width)


def _adpcm4_encode_np(audio: np.ndarray) -> np.ndarray:
    """The numpy version of :func:`_adpcm4_encode` (the JAX package's numpy
    reference encoder)."""
    lead = audio.shape[:-1]
    T = audio.shape[-1]
    nb, width = _adpcm4_geometry(T)
    x = np.clip(
        np.rint(np.asarray(audio, np.float32) * 32768.0), -32768, 32767
    ).astype(np.int32)
    x = x.reshape(-1, nb, ADPCM_BLOCK)
    pred = x[:, :, 0].copy()  # predictor seed = first sample of the block
    # Step-index seed: smallest step covering the block's mean |first diff|
    # (converges the adaptive loop immediately instead of ramping from 0).
    dmean = np.abs(np.diff(x, axis=-1)).mean(axis=-1)
    idx = np.searchsorted(_IMA_STEPS, dmean).astype(np.int32)
    idx = np.clip(idx, 0, 88)
    pred0, idx0 = pred.copy(), idx.copy()
    nib = np.empty((x.shape[0], nb, ADPCM_BLOCK), np.uint8)
    for t in range(ADPCM_BLOCK):
        step = _IMA_STEPS[idx]
        diff = x[:, :, t] - pred
        sign = (diff < 0).astype(np.int32)
        diff = np.abs(diff)
        b4 = (diff >= step).astype(np.int32)
        diff = diff - step * b4
        half = step >> 1
        b2 = (diff >= half).astype(np.int32)
        diff = diff - half * b2
        b1 = (diff >= (step >> 2)).astype(np.int32)
        mag = (b4 << 2) | (b2 << 1) | b1
        nib[:, :, t] = ((sign << 3) | mag).astype(np.uint8)
        # Decoder mirror (must match the decode exactly).
        diffq = (step >> 3) + b4 * step + b2 * half + b1 * (step >> 2)
        pred = np.clip(pred + np.where(sign > 0, -diffq, diffq), -32768, 32767)
        idx = np.clip(idx + _IMA_INDEX[mag], 0, 88)
    header = np.empty((x.shape[0], nb, _ADPCM_HEADER_BYTES), np.uint8)
    u = (pred0 & 0xFFFF).astype(np.uint16)
    header[:, :, 0] = (u & 0xFF).astype(np.uint8)
    header[:, :, 1] = (u >> 8).astype(np.uint8)
    header[:, :, 2] = idx0.astype(np.uint8)
    header[:, :, 3] = 0
    packed = (nib[:, :, 0::2] | (nib[:, :, 1::2] << 4)).astype(np.uint8)
    out = np.concatenate(
        [header.reshape(x.shape[0], -1), packed.reshape(x.shape[0], -1)],
        axis=1,
    )
    return out.reshape(*lead, width)


def adpcm4_decode_np(wire: np.ndarray) -> np.ndarray:
    """Host decode, the JAX package's numpy mirror of the device decode."""
    lead = wire.shape[:-1]
    W = wire.shape[-1]
    nb = W // (_ADPCM_HEADER_BYTES + ADPCM_BLOCK // 2)
    w = wire.reshape(-1, W).astype(np.int32)
    header = w[:, : nb * _ADPCM_HEADER_BYTES].reshape(-1, nb, _ADPCM_HEADER_BYTES)
    pred = header[:, :, 0] | (header[:, :, 1] << 8)
    pred = np.where(pred >= 32768, pred - 65536, pred)
    idx = np.clip(header[:, :, 2], 0, 88)
    packed = w[:, nb * _ADPCM_HEADER_BYTES :].reshape(-1, nb, ADPCM_BLOCK // 2)
    nib = np.stack([packed & 15, packed >> 4], axis=-1).reshape(
        -1, nb, ADPCM_BLOCK
    )
    out = np.empty((w.shape[0], nb, ADPCM_BLOCK), np.int32)
    for t in range(ADPCM_BLOCK):
        code = nib[:, :, t]
        mag = code & 7
        step = _IMA_STEPS[idx]
        diffq = (
            (step >> 3)
            + np.where(mag & 4, step, 0)
            + np.where(mag & 2, step >> 1, 0)
            + np.where(mag & 1, step >> 2, 0)
        )
        pred = np.clip(
            pred + np.where(code & 8, -diffq, diffq), -32768, 32767
        )
        idx = np.clip(idx + _IMA_INDEX[mag], 0, 88)
        out[:, :, t] = pred
    return (out.reshape(*lead, nb * ADPCM_BLOCK).astype(np.float32)) / 32768.0


def _adpcm4_decode(wire: torch.Tensor) -> torch.Tensor:
    """Device decode: ADPCM_BLOCK steps of elementwise int32 ops over
    (batch x blocks) lanes, on the wire tensor's device. Everything that
    depends on the nibble alone (the magnitude bits, the sign, the index
    step) is computed for all 64 steps at once; the loop carries only the
    predictor and the step index. The table lookups index with int64."""
    device = wire.device
    steps_t = torch.as_tensor(_IMA_STEPS, device=device)
    index_t = torch.as_tensor(_IMA_INDEX, device=device, dtype=torch.int64)
    lead = wire.shape[:-1]
    W = wire.shape[-1]
    nb = W // (_ADPCM_HEADER_BYTES + ADPCM_BLOCK // 2)
    w = wire.reshape(-1, W).to(torch.int32)
    header = w[:, : nb * _ADPCM_HEADER_BYTES].reshape(-1, nb, _ADPCM_HEADER_BYTES)
    pred = (header[:, :, 0] | (header[:, :, 1] << 8)).reshape(-1)
    pred = torch.where(pred >= 32768, pred - 65536, pred)
    idx = header[:, :, 2].reshape(-1).clamp(0, 88).to(torch.int64)
    packed = w[:, nb * _ADPCM_HEADER_BYTES :].reshape(-1, nb, ADPCM_BLOCK // 2)
    # (64, lanes): step t's nibbles are one contiguous row.
    nib = torch.stack([packed & 15, packed >> 4], dim=-1).reshape(-1, ADPCM_BLOCK).t()
    mag = nib & 7
    b4, b2, b1 = (mag >> 2) & 1, (mag >> 1) & 1, mag & 1
    sign = 1 - ((nib >> 3) & 1) * 2
    adj = index_t[mag.to(torch.int64)]
    out = torch.empty((ADPCM_BLOCK, pred.shape[0]), dtype=torch.int32, device=device)
    for t in range(ADPCM_BLOCK):
        step = steps_t[idx]
        diffq = (step >> 3) + b4[t] * step + b2[t] * (step >> 1) + b1[t] * (step >> 2)
        pred = torch.clamp(pred + sign[t] * diffq, -32768, 32767)
        idx = torch.clamp(idx + adj[t], 0, 88)
        out[t] = pred
    out = out.t().reshape(*lead, nb * ADPCM_BLOCK)
    return out.to(torch.float32) * (1.0 / 32768.0)


def _check(wire_format: str) -> None:
    if wire_format not in WIRE_FORMATS:
        raise ValueError(f"Unknown wire format: {wire_format!r} (use {WIRE_FORMATS})")


def encode_wire(audio: np.ndarray, wire_format: str) -> np.ndarray:
    """Host-side: float32 ``(..., T)`` in [-1, 1] -> wire array."""
    _check(wire_format)
    if wire_format == "float32":
        return np.asarray(audio, np.float32)
    if wire_format == "int16":
        return np.clip(np.asarray(audio, np.float32) * 32768.0, -32768, 32767).astype(np.int16)
    if wire_format == "mulaw":
        return _mulaw_encode(np.asarray(audio, np.float32))
    return _adpcm4_encode(audio)


def decode_wire(audio: torch.Tensor, wire_format: str) -> torch.Tensor:
    """Device-side: wire tensor -> float32 in [-1, 1], on the tensor's device."""
    _check(wire_format)
    if wire_format == "float32":
        return audio.to(torch.float32)
    if wire_format == "int16":
        return audio.to(torch.float32) * (1.0 / 32768.0)
    if wire_format == "adpcm4":
        return _adpcm4_decode(audio)
    y = audio.to(torch.float32) * (1.0 / 127.5) - 1.0
    return torch.sign(y) * ((torch.exp(torch.abs(y) * float(np.log1p(_MU))) - 1.0) / _MU)


def wire_bytes_per_sample(wire_format: str) -> float:
    """Wire bytes per audio sample (adpcm4 includes its header overhead)."""
    _check(wire_format)
    if wire_format == "adpcm4":
        return 0.5 + _ADPCM_HEADER_BYTES / ADPCM_BLOCK
    return {"float32": 4, "int16": 2, "mulaw": 1}[wire_format]


def wire_row_width(num_samples: int, wire_format: str) -> int:
    """Elements (of :func:`wire_np_dtype`) per ``(..., T)`` row on the wire —
    equals ``T`` for the sample-per-element formats, smaller for adpcm4."""
    _check(wire_format)
    if wire_format == "adpcm4":
        return _adpcm4_geometry(num_samples)[1]
    return int(num_samples)


def wire_np_dtype(wire_format: str):
    _check(wire_format)
    return {"float32": np.float32, "int16": np.int16, "mulaw": np.uint8,
            "adpcm4": np.uint8}[wire_format]
