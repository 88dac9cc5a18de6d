"""
Cut: the abstract time-interval view over a Recording (copied from
``lhotse_tpu/cut/base.py``), with the members the data path uses and the
supervisions' frame mask. The cut algebra (split, mix, trim, windows, the
other masks) is not ported.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from lhotse_tpu_torch.audio.utils import VideoInfo
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import Seconds, add_durations, asdict_nonull, fastcopy


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

    def supervisions_feature_mask(self, use_alignment_if_exists: Optional[str] = None) -> np.ndarray:
        """1-D 0/1 mask over frames covered by at least one supervision."""
        from lhotse_tpu_torch.cut.set import compute_supervisions_frame_mask

        return compute_supervisions_frame_mask(
            self, use_alignment_if_exists=use_alignment_if_exists)

    def with_id(self, id_: str) -> "Cut":
        """Return a copy of the Cut with a new ID."""
        return fastcopy(self, id=id_)
