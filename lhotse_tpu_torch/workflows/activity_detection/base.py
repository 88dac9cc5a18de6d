"""
Activity-detection framework base (copied from
``lhotse_tpu/workflows/activity_detection/base.py``): an
``ActivityDetector`` resamples a recording to its model rate, runs
``forward(track) -> List[Activity]`` per channel, and wraps the spans in
``SupervisionSegment``s with deterministic ids.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import List

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.supervision import SupervisionSegment


@dataclass
class Activity:
    start: float
    duration: float


class ActivityDetector(abc.ABC):
    def __init__(self, detector_name: str, sampling_rate: int, device: str = "cpu"):
        self._detector_name = detector_name
        self._sampling_rate = sampling_rate
        self._device = device

    @property
    def device(self) -> str:
        return self._device

    def __call__(self, recording: Recording) -> List[SupervisionSegment]:
        resampled = recording.resample(self._sampling_rate)
        audio = resampled.load_audio()

        result: List[SupervisionSegment] = []
        for channel, track in enumerate(audio):
            for i, activity in enumerate(self.forward(np.squeeze(track))):
                result.append(
                    SupervisionSegment(
                        id=(
                            f"{recording.id}-{self._detector_name}"
                            f"-{channel}-{i:05}"
                        ),
                        recording_id=recording.id,
                        start=activity.start,
                        duration=activity.duration,
                        channel=channel,
                    )
                )
        return result

    @abc.abstractmethod
    def forward(self, track: np.ndarray) -> List[Activity]:
        raise NotImplementedError()

    @classmethod
    def force_download(cls):
        """Preload / reset any model state (no-op for model-free detectors)."""
        pass
