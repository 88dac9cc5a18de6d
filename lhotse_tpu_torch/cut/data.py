"""
DataCut: the shared part of MonoCut and MultiCut, one Recording plus
supervisions and custom fields viewed through a [start, start+duration)
window (copied from ``lhotse_tpu/cut/data.py``), with the members the data
path uses: the ``Features`` manifest, ``compute_and_store_features`` and
``drop_features``. Images and the lazy waveform-domain builders are not
ported.
"""
from __future__ import annotations

from abc import ABCMeta, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.custom import CustomFieldMixin
from lhotse_tpu_torch.cut.base import Cut
from lhotse_tpu_torch.features.base import FeatureExtractor, Features
from lhotse_tpu_torch.features.io import FeaturesWriter
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import (
    Seconds, asdict_nonull, compute_num_frames, compute_num_samples, fastcopy,
    rich_exception_info)


@dataclass
class DataCut(Cut, CustomFieldMixin, metaclass=ABCMeta):
    """
    A cut backed by real stored data (contrast with MixedCut, which is an
    expression over other cuts).  Concrete subclasses: MonoCut, MultiCut.
    """

    id: str
    start: Seconds
    duration: Seconds
    channel: Union[int, List[int]]
    supervisions: List[SupervisionSegment] = field(default_factory=list)
    features: Optional[Features] = None
    recording: Optional[Recording] = None
    custom: Optional[Dict[str, Any]] = None

    # -- serialization ------------------------------------------------------------

    def to_dict(self) -> dict:
        d = asdict_nonull(self)
        if self.supervisions:
            # Delegate to SupervisionSegment.to_dict: plain dataclass recursion
            # would leave AlignmentItem NamedTuples embedded, which JSON
            # happens to dump as lists but YAML refuses to represent.
            d["supervisions"] = [s.to_dict() for s in self.supervisions]
        if self.has_recording:
            d["recording"] = self.recording.to_dict()
        for k, v in (self.custom or {}).items():
            if isinstance(v, Recording):
                d["custom"][k] = v.to_dict()
        d["type"] = type(self).__name__
        return d

    @staticmethod
    @abstractmethod
    def from_dict(data: dict) -> "DataCut":
        ...

    # -- what data is attached -------------------------------------------------------

    has_features = property(lambda self: self.features is not None)
    has_recording = property(lambda self: self.recording is not None)
    has_video = property(lambda self: self.recording is not None and self.recording.has_video)

    def has(self, field: str) -> bool:
        builtin = {
            "recording": self.has_recording, "features": self.has_features, "video": self.has_video}
        if field in builtin:
            return builtin[field]
        return self.custom is not None and field in self.custom

    @property
    def recording_id(self) -> str:
        return self.recording.id if self.has_recording else self.features.recording_id

    # -- geometry ------------------------------------------------------------------

    @property
    def frame_shift(self) -> Optional[Seconds]:
        return self.features.frame_shift if self.has_features else None

    @property
    def num_frames(self) -> Optional[int]:
        if not self.has_features:
            return None
        return compute_num_frames(
            duration=self.duration, frame_shift=self.frame_shift, sampling_rate=self.sampling_rate)

    @property
    def num_samples(self) -> Optional[int]:
        if not self.has_recording:
            return None
        return compute_num_samples(self.duration, self.sampling_rate)

    num_features = property(lambda self: self.features.num_features if self.has_features else None)
    features_type = property(lambda self: self.features.type if self.has_features else None)

    @property
    @abstractmethod
    def num_channels(self) -> Optional[int]:
        ...

    @property
    def sampling_rate(self) -> int:
        source = self.features if self.has_features else self.recording
        return source.sampling_rate

    # -- data loading (concrete in Mono/MultiCut) ---------------------------------------

    @rich_exception_info
    @abstractmethod
    def load_features(self, **kwargs) -> Optional[np.ndarray]:
        ...

    @rich_exception_info
    @abstractmethod
    def load_audio(self, **kwargs) -> Optional[np.ndarray]:
        ...

    # -- detachment -----------------------------------------------------------------------

    def drop_features(self) -> "DataCut":
        if not self.has_recording:
            raise AssertionError(
                f"Cannot detach features from a DataCut with no Recording "
                f"(cut ID = {self.id})."
            )
        return fastcopy(self, features=None)

    # -- supervision manipulation ------------------------------------------------------------

    def map_supervisions(
        self, transform_fn: Callable[[SupervisionSegment], SupervisionSegment]) -> "DataCut":
        return fastcopy(self, supervisions=[s.map(transform_fn) for s in self.supervisions])

    def filter_supervisions(self, predicate: Callable[[SupervisionSegment], bool]) -> "DataCut":
        return fastcopy(self, supervisions=[s for s in self.supervisions if predicate(s)])

    # -- feature extraction --------------------------------------------------------------------

    def compute_and_store_features(
        self, extractor: FeatureExtractor, storage: FeaturesWriter, augment_fn=None, *args,
        **kwargs) -> "DataCut":
        """Extract + persist features for this window; returns the cut with
        the Features manifest attached."""
        manifest = extractor.extract_from_samples_and_store(
            samples=self.load_audio(), storage=storage, sampling_rate=self.sampling_rate,
            offset=self.start, channel=self.channel, augment_fn=augment_fn)
        return fastcopy(self, features=manifest)

