"""
PaddingCut: synthetic silence used to even out cut lengths (copied from
``lhotse_tpu/cut/padding.py``). It materializes zeros (audio) or a
constant ``feat_value`` (features, typically LOG_EPSILON) on load; every
transformation is metadata-only. ``clip_amplitude`` and ``compress`` are
the port's own: the JAX package lacks them, so its ``ClippingTransform``
and ``Compress`` cut transforms fail on the concatenated cuts of
``CutConcatenate``. Video is not ported.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.utils import VideoInfo
from lhotse_tpu_torch.cut.base import Cut
from lhotse_tpu_torch.utils import (
    LOG_EPSILON, Seconds, compute_num_frames, compute_num_samples, fastcopy, not_ported,
    perturb_num_samples, uuid4)


@dataclass
class PaddingCut(Cut):
    """A dummy Cut that returns zero samples / constant feature values; its
    role is to be appended to other cuts to make them evenly sized."""

    id: str
    duration: Seconds
    sampling_rate: int
    feat_value: float

    # Frequency domain
    num_frames: Optional[int] = None
    num_features: Optional[int] = None
    frame_shift: Optional[float] = None

    # Time domain
    num_samples: Optional[int] = None
    video: Optional[VideoInfo] = None

    # Padding values for custom array attributes
    custom: Optional[dict] = None

    # Constant facts about synthetic silence.
    start = property(lambda self: 0)
    supervisions = property(lambda self: [])
    channel = property(lambda self: 0)
    num_channels = property(lambda self: 1)
    is_in_memory = property(lambda self: False)
    recording_id = property(lambda self: "PAD")

    has_features = property(lambda self: self.num_frames is not None)
    has_recording = property(lambda self: self.num_samples is not None)
    has_video = property(lambda self: self.has_recording and self.video is not None)

    def has(self, field: str) -> bool:
        known = {
            "recording": lambda: self.has_recording, "features": lambda: self.has_features,
            "video": lambda: self.has_video}
        if field in known:
            return known[field]()
        return self.custom is not None and field in self.custom

    def iter_data(self) -> Iterable:
        return ()

    # ---- materialization: the only place data is "loaded" ----

    def _silence(self) -> np.ndarray:
        n = compute_num_samples(self.duration, self.sampling_rate)
        return np.zeros((1, n), np.float32)

    def load_features(self, *args, **kwargs) -> Optional[np.ndarray]:
        if not self.has_features:
            return None
        return np.full((self.num_frames, self.num_features), self.feat_value, np.float32)

    def load_audio(self, *args, **kwargs) -> Optional[np.ndarray]:
        return self._silence() if self.has_recording else None

    def load_video(self, with_audio: bool = True):
        raise not_ported("PaddingCut.load_video")

    # ---- metadata-only transformations ----

    def _resized(self, new_duration: Seconds, preserve_id: bool) -> "PaddingCut":
        """Copy with a new duration and rescaled frame/sample counts."""
        assert new_duration > 0.0
        frames = samples = None
        if self.num_frames is not None:
            frames = compute_num_frames(
                duration=new_duration, frame_shift=self.frame_shift,
                sampling_rate=self.sampling_rate)
        if self.num_samples is not None:
            samples = compute_num_samples(new_duration, self.sampling_rate)
        return fastcopy(
            self, id=self.id if preserve_id else str(uuid4()), duration=new_duration,
            num_frames=frames, num_samples=samples)

    def truncate(
        self, *, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        keep_excessive_supervisions: bool = True, preserve_id: bool = False, **kwargs,
    ) -> "PaddingCut":
        new_duration = self.duration - offset if duration is None else duration
        return self._resized(new_duration, preserve_id)

    def extend_by(
        self, *, duration: Seconds, direction: str = "both", preserve_id: bool = False,
        pad_silence: bool = True) -> "PaddingCut":
        """Extend by ``duration`` (on both sides when direction='both')."""
        growth = duration * (2 if direction == "both" else 1)
        return self._resized(self.duration + growth, preserve_id)

    def pad(
        self, duration: Seconds = None, num_frames: int = None, num_samples: int = None,
        pad_feat_value: float = LOG_EPSILON, direction: str = "right", preserve_id: bool = False,
        pad_value_dict: Optional[Dict[str, Union[int, float]]] = None) -> Cut:
        from lhotse_tpu_torch.cut.set import pad

        return pad(
            self, duration=duration, num_frames=num_frames, num_samples=num_samples,
            pad_feat_value=pad_feat_value, direction=direction, preserve_id=preserve_id,
            pad_value_dict=pad_value_dict)

    def resample(
        self, sampling_rate: int, affix_id: bool = False, recording_field: Optional[str] = None,
    ) -> "PaddingCut":
        """Metadata-only resample mimic."""
        assert self.has_recording, "Cannot resample a PaddingCut without Recording."
        return fastcopy(
            self, id=f"{self.id}_rs{sampling_rate}" if affix_id else self.id,
            sampling_rate=sampling_rate,
            num_samples=compute_num_samples(self.duration, sampling_rate), num_frames=None,
            num_features=None, frame_shift=None)

    def _retimed(self, factor: float, tag: str, affix_id: bool) -> "PaddingCut":
        """Shared speed/tempo mimic: rescale the sample count; feature dims
        cannot survive a time-scale change and are detached."""
        feat_dims = {}
        if self.has_features:
            logging.warning(
                f"Perturbing {tag == 'sp' and 'speed' or 'tempo'} on a PaddingCut "
                "with feature metadata: the feature dims will be detached."
            )
            feat_dims = dict(num_frames=None, num_features=None, frame_shift=None)
        samples = perturb_num_samples(self.num_samples, factor)
        return fastcopy(
            self, id=f"{self.id}_{tag}{factor}" if affix_id else self.id, num_samples=samples,
            duration=samples / self.sampling_rate, **feat_dims)

    def perturb_speed(self, factor: float, affix_id: bool = True) -> "PaddingCut":
        return self._retimed(factor, "sp", affix_id)

    def perturb_tempo(self, factor: float, affix_id: bool = True) -> "PaddingCut":
        return self._retimed(factor, "tp", affix_id)

    def perturb_volume(self, factor: float, affix_id: bool = True) -> "PaddingCut":
        """Volume has no effect on silence — only the ID changes."""
        return fastcopy(self, id=f"{self.id}_vp{factor}" if affix_id else self.id)

    def reverb_rir(
        self, rir_recording: Optional["Recording"] = None, normalize_output: bool = True,
        early_only: bool = False, affix_id: bool = True, rir_channels: List[int] = [0],
        room_rng_seed: Optional[int] = None, source_rng_seed: Optional[int] = None) -> "PaddingCut":
        """Reverb has no effect on silence — only the ID changes."""
        return fastcopy(self, id=f"{self.id}_rvb" if affix_id else self.id)

    def normalize_loudness(self, target: float, affix_id: bool = False, **kwargs) -> "PaddingCut":
        return fastcopy(self, id=f"{self.id}_ln{target}" if affix_id else self.id)

    def clip_amplitude(self, gain_db: float = 0.0, affix_id: bool = True, **kwargs) -> "PaddingCut":
        """Clipping has no effect on silence — only the ID changes. The JAX
        package's PaddingCut has no ``clip_amplitude``, so clipping a
        ``MixedCut`` with a padding track (as ``CutConcatenate`` builds)
        raises ``AttributeError`` there."""
        return fastcopy(self, id=f"{self.id}_cl{gain_db}" if affix_id else self.id)

    def narrowband(
        self, codec: str, restore_orig_sr: bool = True, affix_id: bool = True) -> "PaddingCut":
        """A codec has no effect on silence — only the ID changes. The JAX
        package's PaddingCut has no ``narrowband``."""
        return fastcopy(self, id=f"{self.id}_nb_{codec}" if affix_id else self.id)

    def dereverb_wpe(self, affix_id: bool = True) -> "PaddingCut":
        """Dereverberation has no effect on silence — only the ID changes.
        The JAX package's PaddingCut has no ``dereverb_wpe``."""
        return fastcopy(self, id=f"{self.id}_wpe" if affix_id else self.id)

    def drop_features(self) -> "PaddingCut":
        assert self.has_recording, (
            f"Cannot detach features from a PaddingCut with no Recording (cut ID = {self.id})."
        )
        return fastcopy(self, num_frames=None, num_features=None, frame_shift=None)

    def drop_recording(self) -> "PaddingCut":
        assert self.has_features, (
            f"Cannot detach recording from a PaddingCut with no Features (cut ID = {self.id})."
        )
        return fastcopy(self, num_samples=None)

    def compute_and_store_features(self, extractor, *args, **kwargs) -> Cut:
        """Update feature-dim metadata per the extractor; no actual compute."""
        return fastcopy(
            self, num_features=extractor.feature_dim(self.sampling_rate),
            num_frames=compute_num_frames( duration=self.duration, frame_shift=extractor.frame_shift, sampling_rate=self.sampling_rate, ),
            frame_shift=extractor.frame_shift)

    # Supervision/storage manipulations are all no-ops on synthetic silence.

    def _pass_through(self, *args, **kwargs) -> "PaddingCut":
        return self

    drop_supervisions = _pass_through
    drop_alignments = _pass_through
    drop_in_memory_data = _pass_through
    fill_supervision = _pass_through
    move_to_memory = _pass_through
    map_supervisions = _pass_through
    merge_supervisions = _pass_through
    filter_supervisions = _pass_through
    with_features_path_prefix = _pass_through
    with_recording_path_prefix = _pass_through
    # Padding stays synthetic silence. The JAX package's PaddingCut
    # has no ``compress``, so compressing a MixedCut with a padding track
    # raises ``AttributeError`` there.
    compress = _pass_through

    @staticmethod
    def from_dict(data: dict) -> "PaddingCut":
        data.pop("type", None)
        return PaddingCut(**data)
