"""
Amplitude clipping transform (copied from
``lhotse_tpu/augmentation/clipping.py``): optional 0 dBFS normalization,
pre-gain, hard clip or tanh saturation, gain and normalization reverted
afterwards; a signal below -96 dBFS peak passes through. Wired via
``Recording.clip_amplitude`` with optional oversampling (resample up ->
clip -> resample down).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lhotse_tpu_torch.augmentation.transform import AudioTransform


@dataclass
class Clipping(AudioTransform):
    """Clips/saturates the input signal to the [-1, 1] range."""

    hard: bool = False
    gain_db: float = 0.0
    normalize: bool = True

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        max_peak_amplitude = np.max(np.abs(samples))
        # Treat signals below -96 dBFS peak as silence.
        if max_peak_amplitude == 0 or 20 * np.log10(max_peak_amplitude) < -96:
            return samples.copy()
        if self.normalize:
            samples = samples / max_peak_amplitude
        gain_linear = 1.0
        if abs(self.gain_db) >= 0.1:
            gain_linear = 10 ** (self.gain_db / 20.0)
            samples = samples * gain_linear
        if self.hard:
            saturated = np.clip(samples, -1.0, 1.0)
        else:
            saturated = np.tanh(samples)
        if abs(self.gain_db) >= 0.1:
            saturated = saturated / gain_linear
        if self.normalize:
            saturated = saturated * max_peak_amplitude
        return saturated.copy()

    def reverse_timestamps(self, offset, duration, sampling_rate):
        return offset, duration
