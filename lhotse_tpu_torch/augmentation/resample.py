"""
Bandlimited sinc-interpolation resampler on the host (copied from
``lhotse_tpu/augmentation/resample.py``): the polyphase windowed-sinc
kernel (frequencies reduced by their gcd, one FIR filter per output phase,
anti-aliasing cutoff ``min(orig, new) * 0.99``, hann-squared window of
width 6, built in float64 and cached as float32) applied by the ``dsp``
library's ``sinc_resample_f32`` (:mod:`lhotse_tpu_torch.ops.host_dsp`), the
same C source the JAX package runs. There is no numpy fallback: a failed
build of the library raises. Only the ``sinc_interp_hann`` method is kept.

Both caches (kernels and resamplers) hold the ``CACHE_SIZE`` most recently
used entries. The JAX package's caches never evict, and a lowpass by
resampling (``LowpassUsingResampling``) draws a new ratio per cut, whose
gcd-reduced kernel can take over 100 MB.

The batched on-device variant lives in :mod:`lhotse_tpu_torch.ops.resample`.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Tuple

import numpy as np

from lhotse_tpu_torch.ops import host_dsp


def _sinc_resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99,
) -> Tuple[np.ndarray, int]:
    """Build the polyphase kernel (new_freq, 2*width + orig_freq) and width."""
    assert int(orig_freq) == orig_freq and int(new_freq) == new_freq
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig_freq = int(orig_freq) // gcd
    new_freq = int(new_freq) // gcd

    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2

    t *= math.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * scale
    return kernels.astype(np.float32), width


# Speed, resample, clipping and narrowband use a few fixed ratios.
CACHE_SIZE = 8


_CACHE_LOCK = threading.Lock()


def _lru_get(cache: OrderedDict, key, build):
    """``cache[key]``, built on a miss (outside the lock: a kernel takes
    seconds); keeps the ``CACHE_SIZE`` most recently used entries."""
    with _CACHE_LOCK:
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
    value = build()
    with _CACHE_LOCK:
        cache[key] = value
        while len(cache) > CACHE_SIZE:
            cache.popitem(last=False)
    return value


_KERNEL_CACHE: "OrderedDict[Tuple[int, int, int, float], Tuple[np.ndarray, int]]" = OrderedDict()


def get_sinc_resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99,
) -> Tuple[np.ndarray, int]:
    key = (int(orig_freq), int(new_freq), lowpass_filter_width, rolloff)
    return _lru_get(_KERNEL_CACHE, key, lambda: _sinc_resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff))


def resample_array(
    waveform: np.ndarray, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
    rolloff: float = 0.99) -> np.ndarray:
    """
    Resample ``waveform`` of shape (..., time) from ``orig_freq`` to
    ``new_freq`` with the cached polyphase sinc kernel.
    """
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(int(orig_freq), int(new_freq))
    o = int(orig_freq) // gcd
    n = int(new_freq) // gcd
    kernel, width = get_sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)

    shape = waveform.shape
    x = waveform.reshape(-1, shape[-1]).astype(np.float32, copy=False)
    num_wavs, length = x.shape
    x = np.pad(x, ((0, 0), (width, width + o)))
    num_blocks = (x.shape[1] - kernel.shape[1]) // o + 1
    target_length = int(math.ceil(n * length / o))

    rows = [host_dsp.sinc_resample(row, num_blocks, kernel, o) for row in x]
    if num_wavs == 1:
        # Mono hot path: the trimmed row is a contiguous view — no copy.
        return rows[0][:target_length].reshape(shape[:-1] + (target_length,))
    out = np.stack([r[:target_length] for r in rows])
    return out.reshape(shape[:-1] + (target_length,))


class SincResampler:
    """Object API over :func:`resample_array` with a precomputed kernel,
    mirroring the reference's cached-module pattern
    (`augmentation/torchaudio.py:74` get_or_create_resampler)."""

    def __init__(self, orig_freq: int, new_freq: int):
        self.orig_freq = int(orig_freq)
        self.new_freq = int(new_freq)
        if self.orig_freq != self.new_freq:
            get_sinc_resample_kernel(self.orig_freq, self.new_freq)

    def __call__(self, waveform: np.ndarray) -> np.ndarray:
        return resample_array(waveform, self.orig_freq, self.new_freq)


_RESAMPLERS: "OrderedDict[Tuple[int, int], SincResampler]" = OrderedDict()


def get_or_create_resampler(
    source_sampling_rate: int, target_sampling_rate: int) -> SincResampler:
    """Cached resampler lookup (reference: augmentation/torchaudio.py:74)."""
    key = (int(source_sampling_rate), int(target_sampling_rate))
    return _lru_get(_RESAMPLERS, key, lambda: SincResampler(*key))


def resample(
    waveform: np.ndarray,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
    resampling_method: str = "sinc_interp_hann",
    beta=None,
) -> np.ndarray:
    """
    Functional bandlimited-sinc resampling (the torchaudio-derived API).
    Only the default ``sinc_interp_hann`` method is implemented.
    """
    if resampling_method != "sinc_interp_hann":
        raise ValueError(
            f"Unsupported resampling_method: {resampling_method!r} "
            f"(only 'sinc_interp_hann' is implemented)"
        )
    return resample_array(
        np.asarray(waveform), orig_freq, new_freq,
        lowpass_filter_width=lowpass_filter_width, rolloff=rolloff)
