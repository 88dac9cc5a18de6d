"""
Model-free energy VAD as an :class:`ActivityDetector` (copied from
``lhotse_tpu/workflows/activity_detection/energy_vad.py``): host numpy in
float64 through :func:`.energy._energy_spans`. It needs no weights; its
``device`` is accepted and not used.
"""
from __future__ import annotations

from typing import List

import numpy as np

from lhotse_tpu_torch.workflows.activity_detection.base import Activity, ActivityDetector
from lhotse_tpu_torch.workflows.activity_detection.energy import _energy_spans


class EnergyVAD(ActivityDetector):
    """Frame-RMS thresholding relative to the track's peak RMS."""

    def __init__(
        self, sampling_rate: int = 16000, device: str = "cpu", threshold: float = 0.01,
        min_duration: float = 0.25, min_pause: float = 0.15, frame_size: float = 0.025,
        frame_shift: float = 0.010):
        super().__init__(detector_name="energy_vad", sampling_rate=sampling_rate, device=device)
        self.threshold = threshold
        self.min_duration = min_duration
        self.min_pause = min_pause
        self.frame_size = frame_size
        self.frame_shift = frame_shift

    def forward(self, track: np.ndarray) -> List[Activity]:
        spans = _energy_spans(
            track, self._sampling_rate, len(track) / self._sampling_rate,
            threshold=self.threshold, min_duration=self.min_duration, min_pause=self.min_pause,
            frame_size=self.frame_size, frame_shift=self.frame_shift)
        return [Activity(start=start, duration=duration) for start, duration in spans]
