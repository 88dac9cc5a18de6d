"""
Narrowband (telephone-channel) effect (copied from
``lhotse_tpu/augmentation/narrowband.py``): downsample to 8 kHz, run
through a narrowband codec (encode+decode), optionally resample back. The
mu-law codec is G.711 companding in numpy; ``lpc10`` needs the SpanDSP
library (``libspandsp.so``, through ctypes) and raises ``RuntimeError``
without it, as in the JAX package.

Restoring the source rate brings each channel back to its own length. The
JAX package resizes the whole result to one row of ``channels * length``
samples, which gives a multi-channel input whose length changes over the
round trip the wrong shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from lhotse_tpu_torch.augmentation.resample import get_or_create_resampler
from lhotse_tpu_torch.augmentation.transform import AudioTransform
from lhotse_tpu_torch.utils import Seconds

LPC10_FRAME_SAMPLES = 180
LPC10_FRAME_BYTES = 7


class MuLawCodec:
    """G.711 mu-law encode+decode round trip (256 levels)."""

    mu = 255.0

    def __call__(self, samples: np.ndarray) -> np.ndarray:
        x = np.clip(samples, -1.0, 1.0)
        # encode
        y = np.sign(x) * np.log1p(self.mu * np.abs(x)) / np.log1p(self.mu)
        q = np.round((y + 1) / 2 * self.mu).astype(np.int32)
        # decode
        y2 = (q.astype(np.float64) / self.mu) * 2 - 1
        out = np.sign(y2) * (np.expm1(np.abs(y2) * np.log1p(self.mu))) / self.mu
        return out.astype(samples.dtype)


class Lpc10Codec:
    """LPC10 codec via libspandsp (ctypes); raises when the library is absent."""

    def __init__(self):
        from ctypes import CDLL, POINTER, c_int, c_short, c_uint8, c_void_p

        try:
            api = CDLL("libspandsp.so")
        except OSError:
            raise RuntimeError(
                "The narrowband lpc10 codec requires the SpanDSP library "
                "(libspandsp.so), which is not available in this environment."
            )
        api.lpc10_encode_init.restype = c_void_p
        api.lpc10_encode_init.argtypes = [c_void_p, c_int]
        api.lpc10_encode.restype = c_int
        api.lpc10_encode.argtypes = [c_void_p, POINTER(c_uint8), POINTER(c_short), c_int]
        api.lpc10_encode_free.argtypes = [c_void_p]
        api.lpc10_decode_init.restype = c_void_p
        api.lpc10_decode_init.argtypes = [c_void_p, c_int]
        api.lpc10_decode.restype = c_int
        api.lpc10_decode.argtypes = [c_void_p, POINTER(c_short), POINTER(c_uint8), c_int]
        api.lpc10_decode_free.argtypes = [c_void_p]
        self.api = api

    def __call__(self, samples: np.ndarray) -> np.ndarray:
        from ctypes import POINTER, c_short, c_uint8

        api = self.api
        x = np.clip(samples, -1, 1)
        pcm = (x * 32767).astype(np.int16).reshape(-1)
        n_frames = len(pcm) // LPC10_FRAME_SAMPLES
        pcm = pcm[: n_frames * LPC10_FRAME_SAMPLES].copy()
        enc = api.lpc10_encode_init(None, 0)
        dec = api.lpc10_decode_init(None, 0)
        try:
            coded = np.zeros(n_frames * LPC10_FRAME_BYTES, dtype=np.uint8)
            api.lpc10_encode(
                enc, coded.ctypes.data_as(POINTER(c_uint8)), pcm.ctypes.data_as(POINTER(c_short)),
                len(pcm))
            out = np.zeros(n_frames * LPC10_FRAME_SAMPLES, dtype=np.int16)
            api.lpc10_decode(
                dec, out.ctypes.data_as(POINTER(c_short)), coded.ctypes.data_as(POINTER(c_uint8)),
                len(coded))
        finally:
            api.lpc10_encode_free(enc)
            api.lpc10_decode_free(dec)
        decoded = out.astype(np.float32) / 32768.0
        # Pad back to the original length.
        full = np.zeros(samples.size, dtype=samples.dtype)
        full[: decoded.size] = decoded
        return full.reshape(samples.shape)


CODECS = {"mulaw": MuLawCodec, "lpc10": Lpc10Codec}


@dataclass
class Narrowband(AudioTransform):
    """Resample to 8 kHz, apply a narrowband codec, optionally resample back."""

    codec: str
    source_sampling_rate: int
    restore_orig_sr: bool

    def __post_init__(self):
        if self.codec in CODECS:
            self.codec_instance = CODECS[self.codec]()
        else:
            raise ValueError(f"unsupported codec: {self.codec}")

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        length = samples.shape[-1]
        if self.source_sampling_rate != 8000:
            samples = get_or_create_resampler(self.source_sampling_rate, 8000)(samples)
        samples = self.codec_instance(samples)
        if self.restore_orig_sr and self.source_sampling_rate != 8000:
            samples = get_or_create_resampler(8000, self.source_sampling_rate)(samples)
        if self.restore_orig_sr and samples.shape[-1] != length:
            # Each channel back to its own length, as np.resize does for one.
            samples = np.stack([np.resize(ch, length) for ch in np.atleast_2d(samples)])
        return samples

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: Optional[int],
    ) -> Tuple[Seconds, Optional[Seconds]]:
        return offset, duration
