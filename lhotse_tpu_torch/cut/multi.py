"""
MultiCut: a cut over several channels of a recording (copied from
``lhotse_tpu/cut/multi.py``): per-channel feature and audio loads,
``with_channels``, ``from_mono`` and ``to_mono`` (one MonoCut per channel or
a downmix), lazy reverberation and supervision merging per channel group.
Features come back as ``(C, T, F)`` and the ±1-frame drift is forgiven on
the time axis (the JAX package tests the first axis, the channels). Video
is not ported.
"""
from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass, field
from itertools import groupby
from typing import Any, Callable, Iterable, List, Optional, Sequence, Union

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.cut.data import DataCut
from lhotse_tpu_torch.features.base import Features
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import (
    fastcopy, hash_str_to_int, ifnone, is_equal_or_contains, rich_exception_info, to_list, uuid4)


@dataclass
class MultiCut(DataCut):
    """
    A multi-channel cut (e.g. a microphone-array segment): the Recording has
    multiple channels and supervisions may be tied to any subset of them. The
    cut's channels may be a subset of the Recording's and must be a superset
    of the supervisions'.
    """

    channel: List[int] = field(default_factory=list)

    @property
    def num_channels(self) -> int:
        return len(to_list(self.channel))

    @rich_exception_info
    def load_features(self, channel: Optional[Union[int, List[int]]] = None) -> Optional[np.ndarray]:
        """Load ``(C, T, F)`` features for this cut's span (optionally a
        channel subset), forgiving off-by-one frame mismatches."""
        if not self.has_features:
            return None
        feats = self.features.load(
            start=self.start, duration=self.duration,
            channel_id=self.channel if channel is None else channel)
        drift = feats.shape[-2] - self.num_frames
        if drift == 1:
            return feats[..., : self.num_frames, :]
        if drift == -1:
            return np.concatenate((feats, feats[..., -1:, :]), axis=-2)
        return feats

    @rich_exception_info
    def load_audio(self, channel: Optional[Union[int, List[int]]] = None) -> Optional[np.ndarray]:
        """Load audio: shape (C, N)."""
        if not self.has_recording:
            return None
        return self.recording.load_audio(
            channels=self.channel if channel is None else channel, offset=self.start,
            duration=self.duration)

    def reverb_rir(
        self, rir_recording: Optional[Union[Recording, DataCut]] = None,
        normalize_output: bool = True, early_only: bool = False, affix_id: bool = True,
        rir_channels: Sequence[int] = (0,), room_rng_seed: Optional[int] = None,
        source_rng_seed: Optional[int] = None) -> "MultiCut":
        """Lazy reverberation; synthetic RIRs are supported only for
        single-channel MultiCuts."""
        assert self.has_recording, "Cannot apply reverberation on a MultiCut without Recording."
        if self.has_features:
            logging.warning(
                "Reverberating a MultiCut with pre-computed features: the feature "
                "manifest will be detached."
            )
            self.features = None
        if rir_recording is None:
            assert self.num_channels == 1, (
                "Reverberation simulation for multi-channel recordings is not "
                "supported; provide an impulse response."
            )
            # Synthetic FRA-RIR path: deterministic per-cut seeds.
            if room_rng_seed is None:
                room_rng_seed = hash_str_to_int(str(uuid4()) + self.id, max_value=2**31)
            source_rng_seed = ifnone(source_rng_seed, room_rng_seed)
        else:
            bad = [c for c in rir_channels if c >= rir_recording.num_channels]
            assert not bad, "Invalid channel index in `rir_channels`."
        return fastcopy(
            self, id=f"{self.id}_rvb" if affix_id else self.id,
            recording=self.recording.reverb_rir(
                rir_recording=rir_recording, normalize_output=normalize_output,
                early_only=early_only, affix_id=affix_id, rir_channels=rir_channels,
                room_rng_seed=room_rng_seed, source_rng_seed=source_rng_seed),
            supervisions=[s.reverb_rir(affix_id=affix_id) for s in self.supervisions])

    def merge_supervisions(
        self, merge_policy: str = "delimiter", merge_channels: bool = True,
        custom_merge_fn: Optional[Callable[[str, Iterable[Any]], Any]] = None) -> "MultiCut":
        """
        Merge supervisions into one segment (channel = union of channels), or
        one per channel group when ``merge_channels=False``.
        """
        from lhotse_tpu_torch.cut.data import (
            has_overlapping_texts, make_supervision_mergers, merge_segment_group)

        join, join_custom = make_supervision_mergers(merge_policy, custom_merge_fn)
        sups = sorted(self.supervisions, key=lambda s: s.start)
        if len(sups) <= 1:
            return self

        if merge_channels:
            all_channels = set()
            for s in sups:
                all_channels.update(set(to_list(s.channel)))
            sups_by_channel = {tuple(sorted(all_channels)): sups}
        else:
            sups_by_channel = {
                tuple(to_list(c)): list(csups)
                for c, csups in groupby(
                    sorted(sups, key=lambda s: to_list(s.channel)),
                    key=lambda s: s.channel,
                )
            }

        msups = []
        warned_already = False
        for channel, csups in sups_by_channel.items():
            if not warned_already and has_overlapping_texts(csups):
                warnings.warn(
                    "You are merging overlapping supervisions with text transcripts; "
                    f"the result may be unusable for ASR training (cut id: {self.id})."
                )
                warned_already = True
            msups.append(
                merge_segment_group(
                    csups, sampling_rate=self.sampling_rate, channel=list(channel), join=join,
                    join_custom=join_custom))
        return fastcopy(self, supervisions=msups)

    def with_channels(self, channels: Union[List[int], int]) -> DataCut:
        """Select a subset of channels: MonoCut for one, MultiCut otherwise."""
        wanted = [channels] if isinstance(channels, int) else list(channels)
        assert set(wanted).issubset(set(self.recording.channel_ids)), (
            f"Cannot select {channels=}: not a subset of {self.recording.channel_ids=}"
        )
        if len(wanted) == 1:
            return self._extract_channel(wanted[0])
        return fastcopy(self, channel=wanted)

    def _extract_channel(self, channel: int):
        """A MonoCut view of one channel, keeping only its supervisions."""
        from lhotse_tpu_torch.cut.mono import MonoCut

        return MonoCut(
            id=f"{self.id}-{channel}", recording=self.recording, start=self.start,
            duration=self.duration, channel=channel,
            supervisions=[
                fastcopy(s, channel=channel) for s in self.supervisions
                if is_equal_or_contains(s.channel, channel)],
            custom=self.custom)

    @staticmethod
    def from_mono(*cuts: DataCut) -> "MultiCut":
        """
        Merge one or more MonoCuts (matching in everything but channel, each
        with a distinct channel) into a MultiCut.
        """
        from lhotse_tpu_torch.cut.mono import MonoCut

        assert all(isinstance(c, MonoCut) for c in cuts), "All cuts must be MonoCuts"
        assert (
            sum(1 for _ in groupby(cuts, key=lambda c: (c.recording_id, c.start, c.end))) == 1
        ), "Cuts must match in all fields except channel"
        assert len(set(c.channel for c in cuts)) == len(cuts), (
            "All cuts must have a distinct channel"
        )
        first = cuts[0]
        return MultiCut(
            id=first.id, start=first.start, duration=first.duration,
            channel=sorted(c.channel for c in cuts),
            supervisions=[s for c in cuts for s in c.supervisions], features=first.features,
            recording=first.recording, custom=first.custom)

    def to_mono(self, mono_downmix: bool = False) -> Union["DataCut", List["DataCut"]]:
        """One MonoCut per channel, or a single downmixed cut when
        ``mono_downmix=True``, which holds each supervision once (the JAX
        package's holds a supervision once per channel it covers)."""
        from lhotse_tpu_torch.cut.mixed import MixedCut, MixTrack

        mono_cuts = [self._extract_channel(ch) for ch in to_list(self.channel)]
        if not mono_downmix:
            return mono_cuts
        # Downmix: overlay every channel at offset 0 without level changes.
        mixed_cut = MixedCut(
            id=self.id, tracks=[MixTrack(cut=mc, offset=0.0, snr=None) for mc in mono_cuts])
        mono = mixed_cut.to_mono()
        return fastcopy(mono, supervisions=list({s.id: s for s in mono.supervisions}.values()))

    @staticmethod
    def from_dict(data: dict) -> "MultiCut":
        from lhotse_tpu_torch.serialization import deserialize_custom_field

        data.pop("type", None)
        features = Features.from_dict(data.pop("features")) if "features" in data else None
        recording = Recording.from_dict(data.pop("recording")) if "recording" in data else None
        supervision_infos = data.pop("supervisions") if "supervisions" in data else []
        if "custom" in data:
            deserialize_custom_field(data["custom"])
        return MultiCut(
            **data, features=features, recording=recording,
            supervisions=[SupervisionSegment.from_dict(s) for s in supervision_infos])
