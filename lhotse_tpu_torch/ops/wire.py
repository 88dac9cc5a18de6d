"""
Wire formats for host→device audio transfer (port of ``lhotse_tpu/ops/wire.py``).

- ``float32`` — lossless, 4 B/sample;
- ``int16``  — linear PCM, 2 B/sample; decode is bit-exact with the JAX package;
- ``mulaw``  — 8-bit mu-law companding (mu=255), 1 B/sample, lossy.

Encoding runs on the host in numpy (the mu-law encoder is the JAX package's
pure-numpy LUT path); decoding is elementwise tensor math on the device.
``adpcm4`` is not ported yet: every entry point raises ``NotImplementedError``
for it.
"""
from __future__ import annotations

import numpy as np
import torch

WIRE_FORMATS = ("float32", "int16", "mulaw")
_MU = 255.0
_ADPCM4_TODO = (
    "The adpcm4 wire format is not ported to lhotse_tpu_torch yet "
    "(ROADMAP.md, queue A, item A4b: adpcm4 decode).")


def _mulaw_formula(x: np.ndarray) -> np.ndarray:
    """The continuous G.711-curve byte mapping."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    # [-1, 1] -> [0, 255] with 128 = zero.
    return np.clip((y + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


_MULAW_LUT = _mulaw_formula((np.arange(65536, dtype=np.float32) - 32768.0) / 32768.0)


def _mulaw_encode(x: np.ndarray) -> np.ndarray:
    """Mu-law encode via int16 pre-quantization + a 65536-entry LUT built from
    the continuous formula."""
    q = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int32)
    return _MULAW_LUT[q + 32768]


def _check(wire_format: str) -> None:
    if wire_format == "adpcm4":
        raise NotImplementedError(_ADPCM4_TODO)
    if wire_format not in WIRE_FORMATS:
        raise ValueError(f"Unknown wire format: {wire_format!r} (use {WIRE_FORMATS})")


def encode_wire(audio: np.ndarray, wire_format: str) -> np.ndarray:
    """Host-side: float32 ``(..., T)`` in [-1, 1] -> wire array."""
    _check(wire_format)
    if wire_format == "float32":
        return np.asarray(audio, np.float32)
    if wire_format == "int16":
        return np.clip(np.asarray(audio, np.float32) * 32768.0, -32768, 32767).astype(np.int16)
    return _mulaw_encode(np.asarray(audio, np.float32))


def decode_wire(audio: torch.Tensor, wire_format: str) -> torch.Tensor:
    """Device-side: wire tensor -> float32 in [-1, 1], on the tensor's device."""
    _check(wire_format)
    if wire_format == "float32":
        return audio.to(torch.float32)
    if wire_format == "int16":
        return audio.to(torch.float32) * (1.0 / 32768.0)
    y = audio.to(torch.float32) * (1.0 / 127.5) - 1.0
    return torch.sign(y) * ((torch.exp(torch.abs(y) * float(np.log1p(_MU))) - 1.0) / _MU)


def wire_bytes_per_sample(wire_format: str) -> float:
    """Wire bytes per audio sample."""
    _check(wire_format)
    return {"float32": 4, "int16": 2, "mulaw": 1}[wire_format]


def wire_row_width(num_samples: int, wire_format: str) -> int:
    """Elements (of :func:`wire_np_dtype`) per ``(..., T)`` row on the wire."""
    _check(wire_format)
    return int(num_samples)


def wire_np_dtype(wire_format: str):
    _check(wire_format)
    return {"float32": np.float32, "int16": np.int16, "mulaw": np.uint8}[wire_format]
