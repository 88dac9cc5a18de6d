"""
MonoCut: a single-channel concrete cut (copied from
``lhotse_tpu/cut/mono.py``): audio and feature loading, supervision
handling and (de)serialization.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.cut.data import DataCut
from lhotse_tpu_torch.features.base import Features
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import rich_exception_info


@dataclass
class MonoCut(DataCut):
    """A Cut of a single channel of a Recording — the most common cut type."""

    channel: int = 0

    @property
    def num_channels(self) -> int:
        return 1

    def _span(self) -> dict:
        return dict(channels=self.channel, offset=self.start, duration=self.duration)

    @rich_exception_info
    def load_features(self) -> Optional[np.ndarray]:
        """Load features trimmed to this cut's [start, start+duration] span,
        forgiving off-by-one frame count mismatches."""
        if not self.has_features:
            return None
        feats = self.features.load(start=self.start, duration=self.duration)
        drift = feats.shape[0] - self.num_frames
        if drift == 1:
            return feats[: self.num_frames]
        if drift == -1:
            return np.vstack([feats, feats[-1:]])
        return feats

    @rich_exception_info
    def load_audio(self) -> Optional[np.ndarray]:
        """Load this cut's audio span: shape (1, num_samples)."""
        if not self.has_recording:
            return None
        return self.recording.load_audio(**self._span())

    @staticmethod
    def from_dict(data: dict) -> "MonoCut":
        from lhotse_tpu_torch.serialization import deserialize_custom_field

        data.pop("type", None)
        features = Features.from_dict(data.pop("features")) if "features" in data else None
        recording = Recording.from_dict(data.pop("recording")) if "recording" in data else None
        supervision_infos = data.pop("supervisions") if "supervisions" in data else []
        if "custom" in data:
            deserialize_custom_field(data["custom"])
        return MonoCut(
            **data, features=features, recording=recording,
            supervisions=[SupervisionSegment.from_dict(s) for s in supervision_infos])
