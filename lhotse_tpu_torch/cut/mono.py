"""
MonoCut: a single-channel concrete cut (copied from
``lhotse_tpu/cut/mono.py``): audio and feature loading, channel selection,
lazy reverberation, supervision handling and merging, and (de)serialization. Selecting
several channels and reverberating with a multi-channel RIR return a
``MultiCut``.
"""
from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Sequence, Union

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.cut.data import DataCut
from lhotse_tpu_torch.features.base import Features
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import (
    fastcopy, hash_str_to_int, is_equal_or_contains, rich_exception_info, uuid4)


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

    def with_channels(self, channels: Union[List[int], int]) -> DataCut:
        """Select channels available in the underlying Recording; returns
        MonoCut for one channel, MultiCut otherwise."""
        wanted = [channels] if isinstance(channels, int) else list(channels)
        assert set(wanted).issubset(set(self.recording.channel_ids)), (
            f"Cannot select {channels=}: not a subset of {self.recording.channel_ids=}"
        )
        span = dict(
            recording=self.recording, start=self.start, duration=self.duration, custom=self.custom)
        if len(wanted) == 1:
            (one,) = wanted
            keep = [
                fastcopy(s, channel=one)
                for s in self.supervisions
                if is_equal_or_contains(s.channel, one)
            ]
            return MonoCut(id=f"{self.id}-{one}", channel=one, supervisions=keep, **span)
        from lhotse_tpu_torch.cut.multi import MultiCut

        keep = [s for s in self.supervisions if is_equal_or_contains(wanted, s.channel)]
        return MultiCut(
            id=f"{self.id}-{len(wanted)}chan", channel=wanted, supervisions=keep, **span)

    def reverb_rir(
        self, rir_recording: Optional[Union[Recording, DataCut]] = None,
        normalize_output: bool = True, early_only: bool = False, affix_id: bool = True,
        rir_channels: Sequence[int] = (0,), room_rng_seed: Optional[int] = None,
        source_rng_seed: Optional[int] = None) -> DataCut:
        """
        Lazy reverberation: mono RIR (or a synthetic FRA-RIR) keeps a MonoCut;
        multi-channel RIR selections return a MultiCut with fanned-out channels.
        """
        assert self.has_recording, "Cannot apply reverberation on a MonoCut without Recording."
        if self.has_features:
            logging.warning(
                "Reverberating a MonoCut with pre-computed features: the feature "
                "manifest will be detached."
            )
            self.features = None
        assert rir_recording is None or all(
            c < rir_recording.num_channels for c in rir_channels
        ), "Invalid channel index in `rir_channels`."

        if rir_recording is None:
            # Synthetic FRA-RIR path: derive deterministic per-cut seeds.
            rir_channels = [0]
            if room_rng_seed is None:
                room_rng_seed = hash_str_to_int(str(uuid4()) + self.id, max_value=2**31)
            if source_rng_seed is None:
                source_rng_seed = room_rng_seed

        recording_rvb = self.recording.reverb_rir(
            rir_recording=rir_recording, normalize_output=normalize_output, early_only=early_only,
            affix_id=affix_id, rir_channels=rir_channels, room_rng_seed=room_rng_seed,
            source_rng_seed=source_rng_seed)

        if len(rir_channels) == 1:
            return fastcopy(
                self, id=f"{self.id}_rvb" if affix_id else self.id, recording=recording_rvb,
                supervisions=[s.reverb_rir(affix_id=affix_id) for s in self.supervisions])
        # Multi-channel RIR: the result fans out into a MultiCut.
        if self.recording.num_channels > 1:
            # The JAX package builds the MultiCut all the same: its recording
            # reverberates every one of its channels, pairing channel d with
            # RIR channel d, or fails to load when the counts differ.
            raise ValueError(
                f"Cut {self.id}: a multi-channel RIR fans out a single-channel recording; "
                f"recording {self.recording.id} has {self.recording.num_channels} channels.")
        from lhotse_tpu_torch.cut.multi import MultiCut

        fanout = list(range(len(rir_channels)))
        return fastcopy(
            MultiCut.from_mono(self), recording=recording_rvb,
            supervisions=[
                s.reverb_rir(affix_id=affix_id, channel=fanout) for s in self.supervisions],
            channel=fanout)

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

    def merge_supervisions(
        self, merge_policy: str = "delimiter",
        custom_merge_fn: Optional[Callable[[str, Iterable[Any]], Any]] = None) -> "MonoCut":
        """
        Merge all supervisions into one spanning segment; texts joined with
        whitespace, other string fields joined with "#" (or first kept, per
        ``merge_policy``); alignments concatenated.
        """
        from lhotse_tpu_torch.cut.data import (
            has_overlapping_texts, make_supervision_mergers, merge_segment_group)

        sups = sorted(self.supervisions, key=lambda s: s.start)
        if len(sups) <= 1:
            return self
        if has_overlapping_texts(sups):
            warnings.warn(
                "You are merging overlapping supervisions with text transcripts; "
                f"the result may be unusable for ASR training (cut id: {self.id})."
            )
        join, join_custom = make_supervision_mergers(merge_policy, custom_merge_fn)
        merged = merge_segment_group(
            sups, sampling_rate=self.sampling_rate, channel=sups[0].channel, join=join,
            join_custom=join_custom, group_end=sups[-1].end)
        return fastcopy(self, supervisions=[merged])

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
