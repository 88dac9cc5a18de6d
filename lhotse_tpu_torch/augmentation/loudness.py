"""
EBU R128 / ITU-R BS.1770 loudness normalization (copied from
``lhotse_tpu/augmentation/loudness.py``): a numpy BS.1770-4 meter
(K-weighting prefilters on scipy's ``lfilter``, 400 ms blocks with 75 %
overlap, absolute -70 LUFS and relative -10 LU gating), used when the
optional ``pyloudnorm`` package is not installed; ``pyloudnorm`` is
preferred when it is, as in the JAX package.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from lhotse_tpu_torch.augmentation.transform import AudioTransform
from lhotse_tpu_torch.utils import EPSILON, Seconds, is_module_available

# BS.1770 channel weights: L, R, C, Ls, Rs
_CHANNEL_GAINS = np.array([1.0, 1.0, 1.0, 1.41, 1.41])


def _k_weighting_coeffs(fs: float):
    """Shelving + highpass prefilter coefficients per BS.1770-4 (designed for
    arbitrary sample rates via the pyloudnorm/Brecht De Man parameterization)."""
    # Stage 1: spherical-head shelving filter.
    f0, G, Q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    K = np.tan(np.pi * f0 / fs)
    Vh = np.power(10.0, G / 20.0)
    Vb = np.power(Vh, 0.4996667741545416)
    a0 = 1.0 + K / Q + K * K
    b_shelf = np.array(
        [
            (Vh + Vb * K / Q + K * K) / a0,
            2.0 * (K * K - Vh) / a0,
            (Vh - Vb * K / Q + K * K) / a0,
        ]
    )
    a_shelf = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    # Stage 2: highpass.
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = np.tan(np.pi * f0 / fs)
    den = 1.0 + K / Q + K * K
    a_hp = np.array([1.0, 2.0 * (K * K - 1.0) / den, (1.0 - K / Q + K * K) / den])
    b_hp = np.array([1.0, -2.0, 1.0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def measure_loudness(audio: np.ndarray, sampling_rate: int, block_size: float = 0.4) -> float:
    """
    Integrated loudness in LUFS of ``audio`` with shape (channels, samples),
    per ITU-R BS.1770-4 with gating.
    """
    from scipy.signal import lfilter

    assert audio.ndim == 2
    (b1, a1), (b2, a2) = _k_weighting_coeffs(float(sampling_rate))
    y = lfilter(b1, a1, audio, axis=-1)
    y = lfilter(b2, a2, y, axis=-1)

    T_g = block_size
    overlap = 0.75
    step = int(round(T_g * sampling_rate * (1 - overlap)))
    block = int(round(T_g * sampling_rate))
    n = y.shape[1]
    if n < block or step == 0:
        z = np.mean(y**2, axis=-1)
        gains = _CHANNEL_GAINS[: y.shape[0]]
        return -0.691 + 10 * np.log10(np.sum(gains * z) + EPSILON)

    num_blocks = (n - block) // step + 1
    idx = np.arange(block)[None, :] + step * np.arange(num_blocks)[:, None]
    # (C, num_blocks) mean square per block
    z = np.mean(y[:, idx] ** 2, axis=-1)  # (C, num_blocks)
    gains = _CHANNEL_GAINS[: y.shape[0]][:, None]
    l_k = -0.691 + 10 * np.log10(np.sum(gains * z, axis=0) + EPSILON)

    # Absolute gating at -70 LUFS.
    J_abs = l_k > -70.0
    if not np.any(J_abs):
        return -np.inf
    z_avg = np.mean(z[:, J_abs], axis=1, keepdims=True)
    gamma_r = -0.691 + 10 * np.log10(np.sum(gains * z_avg) + EPSILON) - 10.0
    # Relative gating.
    J_rel = J_abs & (l_k > gamma_r)
    if not np.any(J_rel):
        return -np.inf
    z_avg = np.mean(z[:, J_rel], axis=1, keepdims=True)
    return float(-0.691 + 10 * np.log10(np.sum(gains * z_avg) + EPSILON))


def normalize_loudness(audio: np.ndarray, target: float, sampling_rate: int = 16000) -> np.ndarray:
    """Scale ``audio`` (channels, samples) so its integrated loudness equals
    ``target`` LUFS."""
    assert audio.ndim == 2, f"Expected 2D audio shape, got: {audio.shape}"
    dtype = audio.dtype
    duration = audio.shape[1] / sampling_rate
    if is_module_available("pyloudnorm"):
        import pyloudnorm as pyln

        meter = pyln.Meter(sampling_rate, block_size=min(0.4, duration - EPSILON))
        loudness = meter.integrated_loudness(audio.T)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = pyln.normalize.loudness(audio.T, loudness, target)
        return out.astype(dtype).T
    loudness = measure_loudness(
        audio, sampling_rate, block_size=min(0.4, max(duration - EPSILON, 0.05)))
    if not np.isfinite(loudness):
        return audio
    gain = 10.0 ** ((target - loudness) / 20.0)
    return (audio * gain).astype(dtype)


@dataclass
class LoudnessNormalization(AudioTransform):
    """Loudness normalization to a target LUFS level."""

    target: float

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        return normalize_loudness(
            np.asarray(samples), target=self.target, sampling_rate=sampling_rate)

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: int,
    ) -> Tuple[Seconds, Optional[Seconds]]:
        return offset, duration
