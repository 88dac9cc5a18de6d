"""
Cut: the abstract time-interval view over a Recording (copied from
``lhotse_tpu/cut/base.py``), with the members the data path uses: ``mix``,
``append`` and the supervisions' frame mask. Splitting, trimming to
supervisions, windows and the other masks are not ported.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from lhotse_tpu_torch.audio.utils import VideoInfo
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import Decibels, Seconds, add_durations, asdict_nonull, fastcopy


class Cut:
    """
    Abstract base for audio cuts — a "view" of a chunk of a recording and/or
    precomputed features, with attached supervisions whose time boundaries are
    relative to the cut start. Concrete types: MonoCut, MultiCut, PaddingCut,
    MixedCut. All transformations are lazy and return modified copies.
    """

    # Members/properties implemented by child classes (not abstract due to
    # dataclass interop).
    id: str
    start: Seconds
    duration: Seconds
    sampling_rate: int
    supervisions: List[SupervisionSegment]
    num_samples: Optional[int]
    num_frames: Optional[int]
    num_features: Optional[int]
    frame_shift: Optional[Seconds]
    features_type: Optional[str]
    has_recording: bool
    has_features: bool
    has_video: bool
    video: Optional[VideoInfo]

    @property
    def end(self) -> Seconds:
        return add_durations(self.start, self.duration, sampling_rate=self.sampling_rate)

    def to_dict(self) -> dict:
        d = asdict_nonull(self)
        return {**d, "type": type(self).__name__}

    def copy(self, **replace_attrs):
        """Shallow copy with specified attributes overwritten."""
        return type(self)(**{**self.__dict__, **replace_attrs})

    def copy_with(self, **kwargs) -> "Cut":
        return self.copy(**kwargs)

    def mix(
        self, other: "Cut", offset_other_by: Seconds = 0.0, allow_padding: bool = False,
        snr: Optional[Decibels] = None, preserve_id: Optional[str] = None,
        tag: Optional[str] = None) -> "Cut":
        """Mix ``other`` into this cut (lazy); see :func:`lhotse_tpu_torch.cut.set.mix`."""
        from lhotse_tpu_torch.cut.set import mix

        return mix(
            self, other, offset=offset_other_by, allow_padding=allow_padding, snr=snr,
            preserve_id=preserve_id, tag=tag)

    def append(
        self, other: "Cut", snr: Optional[Decibels] = None, preserve_id: Optional[str] = None,
    ) -> "Cut":
        """Append ``other`` after this cut (mix at offset == self.duration)."""
        from lhotse_tpu_torch.cut.set import mix

        return mix(self, other, offset=self.duration, snr=snr, preserve_id=preserve_id)

    def supervisions_feature_mask(self, use_alignment_if_exists: Optional[str] = None) -> np.ndarray:
        """1-D 0/1 mask over frames covered by at least one supervision."""
        from lhotse_tpu_torch.cut.set import compute_supervisions_frame_mask

        return compute_supervisions_frame_mask(
            self, use_alignment_if_exists=use_alignment_if_exists)

    def with_id(self, id_: str) -> "Cut":
        """Return a copy of the Cut with a new ID."""
        return fastcopy(self, id=id_)
