"""
Core time-domain transforms (copied from
``lhotse_tpu/augmentation/transforms.py``): ``Speed`` (sox ``speed``, a
resample from ``sr*factor`` to ``sr``), ``Resample`` (the sinc resampler;
reverse timestamps snap offsets to the source sample grid with
ROUND_HALF_UP), ``Tempo`` (pitch-preserving WSOLA time stretch, sox
``tempo``) and ``Volume`` (plain gain).

``Resample`` runs the built-in sinc resampler only: the JAX package's sox
backend (selected through :mod:`lhotse_tpu_torch.audio.resampling_backend`
or its environment variables) is not ported and raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from decimal import ROUND_HALF_UP
from typing import Optional, Tuple

import numpy as np

from lhotse_tpu_torch.augmentation.resample import get_or_create_resampler
from lhotse_tpu_torch.augmentation.transform import AudioTransform
from lhotse_tpu_torch.utils import Seconds, compute_num_samples, perturb_num_samples


def _reverse_time_scale(
    factor: float, offset: Seconds, duration: Optional[Seconds], sampling_rate: int,
) -> Tuple[Seconds, Optional[Seconds]]:
    """Map a window of a signal time-scaled by ``factor`` back to the source."""
    start_sample = compute_num_samples(offset, sampling_rate)
    num_samples = (
        compute_num_samples(duration, sampling_rate) if duration is not None else None
    )
    start_sample = perturb_num_samples(start_sample, 1 / factor)
    num_samples = (
        perturb_num_samples(num_samples, 1 / factor)
        if num_samples is not None
        else None
    )
    return (
        start_sample / sampling_rate,
        num_samples / sampling_rate if num_samples is not None else None)


@dataclass
class Speed(AudioTransform):
    """
    Speed perturbation (sox ``speed``): resamples the signal back to the input
    sampling rate, so the output has ``num_samples / factor`` samples.
    """

    factor: float

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        resampler = get_or_create_resampler(round(sampling_rate * self.factor), sampling_rate)
        return resampler(samples)

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: int,
    ) -> Tuple[Seconds, Optional[Seconds]]:
        return _reverse_time_scale(self.factor, offset, duration, sampling_rate)


@dataclass
class Resample(AudioTransform):
    """Resampling effect (sox ``rate``)."""

    source_sampling_rate: int
    target_sampling_rate: int

    def __post_init__(self):
        self.source_sampling_rate = int(self.source_sampling_rate)
        self.target_sampling_rate = int(self.target_sampling_rate)

    def __call__(self, samples: np.ndarray, *args, **kwargs) -> np.ndarray:
        if self.source_sampling_rate == self.target_sampling_rate:
            return samples
        # "sox" routes through the sox rate effect, "default" through the
        # built-in polyphase sinc kernel.
        from lhotse_tpu_torch.audio.resampling_backend import get_current_resampling_backend

        if get_current_resampling_backend() == "sox":
            from lhotse_tpu_torch.tools.libsox import libsox_rate

            return libsox_rate(samples, self.source_sampling_rate, self.target_sampling_rate)
        resampler = get_or_create_resampler(self.source_sampling_rate, self.target_sampling_rate)
        return resampler(samples)

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: int,
    ) -> Tuple[Seconds, Optional[Seconds]]:
        if self.source_sampling_rate == self.target_sampling_rate:
            return offset, duration
        old_num_samples = compute_num_samples(
            offset, self.source_sampling_rate, rounding=ROUND_HALF_UP)
        old_offset = old_num_samples / self.source_sampling_rate
        if duration is not None:
            old_num_samples = compute_num_samples(
                duration, self.source_sampling_rate, rounding=ROUND_HALF_UP)
            old_duration = old_num_samples / self.source_sampling_rate
        else:
            old_duration = None
        return old_offset, old_duration


def wsola_time_stretch(
    samples: np.ndarray, factor: float, sampling_rate: int, segment_ms: float = 82.0,
    search_ms: float = 14.0, overlap_ms: float = 12.0) -> np.ndarray:
    """
    Waveform-similarity overlap-add time stretching (the algorithm behind
    sox's ``tempo`` effect). ``factor > 1`` speeds up (shorter output),
    preserving pitch. Defaults match sox's generic profile.

    Operates on (channels, samples); channels are processed with a shared
    alignment computed from the channel sum (like sox).
    """
    if factor == 1.0:
        return samples
    x = samples
    squeeze = False
    if x.ndim == 1:
        x = x[None, :]
        squeeze = True
    C, N = x.shape

    seg = max(int(round(segment_ms * sampling_rate / 1000.0)), 16)
    overlap = min(int(round(overlap_ms * sampling_rate / 1000.0)), seg // 2)
    search = int(round(search_ms * sampling_rate / 1000.0))

    # Analysis hop in the input; synthesis hop in the output.
    syn_hop = seg - overlap
    ana_hop = factor * syn_hop

    out_len_est = int(np.ceil(N / factor)) + seg
    out = np.zeros((C, out_len_est), dtype=np.float64)
    win = np.hanning(2 * overlap + 1)[1 : overlap + 1] if overlap > 0 else None

    mono = x.sum(axis=0)
    # First segment: copy directly.
    first = x[:, :seg]
    out[:, : first.shape[1]] = first
    out_pos = syn_hop
    k = 1
    while True:
        target = int(round(k * ana_hop))
        if target + seg + search >= N:
            break
        # WSOLA searches around `target` for the start maximizing the
        # normalized cross-correlation with the current output tail.
        lo = max(target - search, 0)
        hi = min(target + search, N - seg)
        if overlap > 0:
            ref = out[:, out_pos : out_pos + overlap].sum(axis=0)
            segment_region = mono[lo : hi + overlap]
            n_cand = hi - lo + 1
            if n_cand <= 0:
                break
            windows = np.lib.stride_tricks.sliding_window_view(segment_region, overlap)[:n_cand]
            scores = windows @ ref
            norm = np.sqrt(np.einsum("ij,ij->i", windows, windows) + 1e-12)
            best = int(np.argmax(scores / norm))
            start = lo + best
        else:
            start = target
        chunk = x[:, start : start + seg]
        if overlap > 0:
            out[:, out_pos : out_pos + overlap] = (
                out[:, out_pos : out_pos + overlap] * win[::-1][None, :]
                + chunk[:, :overlap] * win[None, :]
            )
            out[:, out_pos + overlap : out_pos + seg] = chunk[:, overlap:]
        else:
            out[:, out_pos : out_pos + seg] = chunk
        out_pos += syn_hop
        k += 1

    total = out_pos + overlap
    result = out[:, :total].astype(samples.dtype, copy=False)
    return result[0] if squeeze else result


@dataclass
class Tempo(AudioTransform):
    """Tempo perturbation (sox ``tempo``): pitch-preserving WSOLA time stretch."""

    factor: float

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        sampling_rate = int(sampling_rate)
        out = wsola_time_stretch(np.asarray(samples), self.factor, sampling_rate)
        # Trim/pad to the manifest-declared length so chains stay consistent.
        if samples.ndim == 2:
            n_out = perturb_num_samples(samples.shape[1], self.factor)
            cur = out.shape[1]
            if cur > n_out:
                out = out[:, :n_out]
            elif cur < n_out:
                out = np.pad(out, ((0, 0), (0, n_out - cur)))
        return out

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: int,
    ) -> Tuple[Seconds, Optional[Seconds]]:
        return _reverse_time_scale(self.factor, offset, duration, sampling_rate)


@dataclass
class Volume(AudioTransform):
    """Volume perturbation (sox ``vol``): plain multiplication by a gain."""

    factor: float

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        return samples * self.factor

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: Optional[int],
    ) -> Tuple[Seconds, Optional[Seconds]]:
        return offset, duration
