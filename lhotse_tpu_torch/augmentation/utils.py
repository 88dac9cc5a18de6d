"""
Augmentation helpers (copied from ``lhotse_tpu/augmentation/utils.py``):
FFT convolution and the fast random RIR generator, a numpy/scipy
implementation of FRA-RIR (arXiv:2208.04101).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Callable, List, Optional

import numpy as np

# Signature of a waveform-augmentation callable: (samples, sampling_rate) ->
# augmented samples (reference: augmentation/utils.py).
AugmentFn = Callable[..., np.ndarray]

_NEXT_FAST_LEN = {}


def next_fast_len(size: int) -> int:
    """Next n >= size whose prime factors are all 2, 3, or 5 (fast FFT sizes)."""
    try:
        return _NEXT_FAST_LEN[size]
    except KeyError:
        pass
    assert isinstance(size, int) and size > 0
    next_size = size
    while True:
        remaining = next_size
        for n in (2, 3, 5):
            while remaining % n == 0:
                remaining //= n
        if remaining == 1:
            _NEXT_FAST_LEN[size] = next_size
            return next_size
        next_size += 1


def convolve1d(signal: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """
    Full 1-d convolution of ``signal`` with ``kernel`` using FFTs
    (output length m + n - 1). Reference: augmentation/utils.py:49.
    """
    assert signal.ndim == 1 and kernel.ndim == 1
    m = signal.shape[-1]
    n = kernel.shape[-1]
    padded_size = m + n - 1
    fast_fft_size = next_fast_len(padded_size)
    f_signal = np.fft.rfft(signal, n=fast_fft_size)
    f_kernel = np.fft.rfft(kernel, n=fast_fft_size)
    result = np.fft.irfft(f_signal * f_kernel, n=fast_fft_size)
    return result[:padded_size]


def highpass_biquad(
    waveform: np.ndarray, sample_rate: int, cutoff_freq: float, Q: float = 0.707) -> np.ndarray:
    """RBJ cookbook biquad highpass, applied along the last axis."""
    from scipy.signal import lfilter

    w0 = 2 * np.pi * cutoff_freq / sample_rate
    alpha = np.sin(w0) / (2 * Q)
    cosw0 = np.cos(w0)
    b0 = (1 + cosw0) / 2
    b1 = -(1 + cosw0)
    b2 = (1 + cosw0) / 2
    a0 = 1 + alpha
    a1 = -2 * cosw0
    a2 = 1 - alpha
    b = np.array([b0, b1, b2]) / a0
    a = np.array([1.0, a1 / a0, a2 / a0])
    return lfilter(b, a, waveform, axis=-1)


# Based on the FRA-RIR method (arXiv:2208.04101); mirrors the reference's
# generator structure (augmentation/utils.py:80-230) in pure numpy.
@dataclass
class FastRandomRIRGenerator:
    sr: int = 16000
    direct_range: List = field(default_factory=lambda: [-6, 50])
    max_T60: float = 0.8
    alpha: float = 0.25
    a: float = -2.0
    b: float = 2.0
    tau: float = 0.2
    room_seed: Optional[int] = None
    source_seed: Optional[int] = None

    def __post_init__(self):
        self.room_rng = (
            np.random.default_rng(self.room_seed)
            if self.room_seed is not None
            else np.random.default_rng()
        )
        self.source_rng = (
            np.random.default_rng(self.source_seed)
            if self.source_seed is not None
            else np.random.default_rng()
        )

    def to_dict(self):
        d = asdict(self)
        d.pop("room_rng", None)
        d.pop("source_rng", None)
        return d

    def __call__(self, nsource: int = 1) -> np.ndarray:
        """
        :param nsource: number of RIR filters to simulate.
        :return: simulated RIRs, shape (nsource, nsample) at ``self.sr``.
        """
        from lhotse_tpu_torch.augmentation.resample import get_or_create_resampler

        ratio = 64
        sample_sr = self.sr * ratio
        mid_sr = sample_sr // int(np.sqrt(ratio))

        eps = float(np.finfo(np.float16).eps)
        velocity = 340.0

        # Sample room statistics.
        T60 = float(self.room_rng.uniform(0.1, self.max_T60))
        R = float(self.room_rng.uniform(0.1, 1.2))
        direct_dist = self.source_rng.uniform(0.2, 12.0, size=(nsource,))

        image = self.sr * 2  # number of virtual sources
        direct_idx = np.ceil(direct_dist * sample_sr / velocity).astype(np.int64)
        rir_length = int(np.ceil(sample_sr * T60))

        # Eyring's empirical reflection coefficient.
        reflect_coef = np.sqrt(1 - (1 - np.exp(-0.16 * R / T60)) ** 2)

        # Propagation distances for virtual sources: sampled as ratios of d0.
        dist_prob = np.linspace(self.alpha, 1.0, image) ** 2
        dist_prob = dist_prob / dist_prob.sum()
        dist_select_idx = self.source_rng.choice(
            image, size=(nsource, image), replace=True, p=dist_prob)
        dist_ratio = np.stack(
            [ np.linspace(1.0, velocity * T60 / direct_dist[i] - 1, image)[ dist_select_idx[i] ] for i in range(nsource) ],
            0)
        dist = direct_dist[:, None] * dist_ratio

        # Number of reflections per virtual source.
        reflect_max = (
            np.log10(velocity * T60) - np.log10(direct_dist) - 3
        ) / np.log10(reflect_coef + eps)
        reflect_ratio = (dist / (velocity * T60)) ** 2 * (reflect_max[:, None] - 1) + 1
        reflect_pertub = self.source_rng.uniform(
            self.a, self.b, size=(nsource, image)) * (dist_ratio**self.tau)
        reflect_ratio = np.maximum(reflect_ratio + reflect_pertub, 1.0)

        # Rescaled dirac comb as the RIR filter.
        dist = np.concatenate([direct_dist[:, None], dist], 1)
        reflect_ratio = np.concatenate([np.zeros((nsource, 1)), reflect_ratio], 1)
        rir = np.zeros((nsource, rir_length), dtype=np.float64)
        delta_idx = np.minimum(
            np.ceil(dist * sample_sr / velocity), rir_length - 1).astype(np.int64)
        delta_decay = reflect_coef**reflect_ratio / dist
        for i in range(nsource):
            np.add.at(rir[i], delta_idx[i], delta_decay[i])

        # Direct-path mask (kept for parity with the reference even though we
        # only return the full RIR).
        direct_mask = np.zeros((nsource, rir_length), dtype=np.float64)
        for i in range(nsource):
            lo = max(int(direct_idx[i]) + sample_sr * self.direct_range[0] // 1000, 0)
            hi = min(int(direct_idx[i]) + sample_sr * self.direct_range[1] // 1000, rir_length)
            direct_mask[i, lo:hi] = 1.0
        rir_direct = rir * direct_mask

        all_rir = np.stack([rir, rir_direct], 1).reshape(nsource * 2, -1)
        resample1 = get_or_create_resampler(sample_sr, mid_sr)
        rir_downsample = resample1(all_rir.astype(np.float32))
        rir_hp = highpass_biquad(rir_downsample, mid_sr, 80.0)
        resample2 = get_or_create_resampler(mid_sr, self.sr)
        rir_out = resample2(rir_hp.astype(np.float32)).reshape(nsource, 2, -1)
        return rir_out[:, 0].astype(np.float32)
