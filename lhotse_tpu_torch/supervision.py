"""
SupervisionSegment: segment-level annotations (copied from
``lhotse_tpu/supervision.py``), with ``AlignmentItem`` and the mirrors of
the cut perturbations (speed, tempo, volume, reverb).
``SupervisionSet`` is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

from lhotse_tpu_torch.custom import CustomFieldMixin
from lhotse_tpu_torch.utils import (
    Seconds, add_durations, asdict_nonull, compute_num_samples, fastcopy, ifnone,
    perturb_num_samples)

# Alignment times are quantized against a 48 kHz grid: fine enough for any
# supported audio rate while keeping add_durations() exact.
_TIME_GRID_SR = 48000


def _rescaled_span(start: Seconds, duration: Seconds, factor: float, sampling_rate: int):
    """(start, duration) after speed/tempo scaling by ``factor`` (exact
    sample-count arithmetic, like the audio itself)."""
    begin = perturb_num_samples(compute_num_samples(start, sampling_rate), factor)
    span = perturb_num_samples(compute_num_samples(duration, sampling_rate), factor)
    return begin / sampling_rate, span / sampling_rate


class AlignmentItem(NamedTuple):
    """
    One alignment item (e.g. a word or phone) with its start time (w.r.t. the
    start of the recording) and duration, plus an optional confidence score.
    """

    symbol: str
    """The aligned token (word/phone/...)."""
    start: Seconds
    """Start time relative to the recording start."""
    duration: Seconds
    """Token duration in seconds."""
    score: Optional[float] = None
    """Optional aligner confidence."""

    @staticmethod
    def deserialize(data: Union[List, Dict]) -> "AlignmentItem":
        if isinstance(data, dict):
            # Legacy dict-based alignment format.
            return AlignmentItem(*list(data.values()))
        return AlignmentItem(*data)

    def serialize(self) -> list:
        return list(self)

    @property
    def end(self) -> Seconds:
        return round(self.start + self.duration, ndigits=8)

    def with_offset(self, offset: Seconds) -> "AlignmentItem":
        moved = add_durations(self.start, offset, sampling_rate=_TIME_GRID_SR)
        return self._replace(start=moved)

    def perturb_speed(self, factor: float, sampling_rate: int) -> "AlignmentItem":
        begin, span = _rescaled_span(self.start, self.duration, factor, sampling_rate)
        return self._replace(start=begin, duration=span)


@dataclass
class SupervisionSegment(CustomFieldMixin):
    """
    A time interval annotated with supervision labels/metadata: transcript,
    speaker, language, gender, a free-form ``custom`` dict, and optional
    alignments keyed by type ('word', 'phone', ...).
    """

    id: str
    recording_id: str
    start: Seconds
    duration: Seconds
    channel: Union[int, List[int]] = 0
    text: Optional[str] = None
    language: Optional[str] = None
    speaker: Optional[str] = None
    gender: Optional[str] = None
    custom: Optional[Dict[str, Any]] = None
    alignment: Optional[Dict[str, List[AlignmentItem]]] = None

    @property
    def end(self) -> Seconds:
        return round(self.start + self.duration, ndigits=8)

    def with_alignment(self, kind: str, alignment: List[AlignmentItem]) -> "SupervisionSegment":
        # Copy the dict so the original segment's alignment is not mutated.
        alis = dict(self.alignment) if self.alignment is not None else {}
        alis[kind] = alignment
        return fastcopy(self, alignment=alis)

    def with_offset(self, offset: Seconds) -> "SupervisionSegment":
        """Return an identical segment with ``offset`` added to ``start``."""
        return fastcopy(self, start=round(self.start + offset, ndigits=8))

    def _affixed(self, suffix: str, affix_id: bool, **extra) -> "SupervisionSegment":
        """Copy with '_<suffix>' appended to both ids (when affix_id)."""
        if affix_id:
            extra["id"] = f"{self.id}_{suffix}"
            extra["recording_id"] = f"{self.recording_id}_{suffix}"
        return fastcopy(self, **extra)

    def _map_alignment(self, fn) -> Optional[Dict[str, List[AlignmentItem]]]:
        if not self.alignment:
            return None
        return {kind: [fn(item) for item in ali] for kind, ali in self.alignment.items()}

    def perturb_speed(
        self, factor: float, sampling_rate: int, affix_id: bool = True) -> "SupervisionSegment":
        """Match the time boundaries of a speed-perturbed recording/cut."""
        begin, span = _rescaled_span(self.start, self.duration, factor, sampling_rate)
        return self._affixed(
            f"sp{factor}", affix_id, start=begin, duration=span,
            alignment=self._map_alignment( lambda item: item.perturb_speed(factor=factor, sampling_rate=sampling_rate) ),
        )

    def perturb_tempo(
        self, factor: float, sampling_rate: int, affix_id: bool = True) -> "SupervisionSegment":
        # Speed and tempo perturbation have identical effect on supervisions.
        perturbed = self.perturb_speed(factor, sampling_rate, affix_id=False)
        return perturbed._affixed(f"tp{factor}", affix_id)

    def perturb_volume(self, factor: float, affix_id: bool = True) -> "SupervisionSegment":
        return self._affixed(f"vp{factor}", affix_id)

    def reverb_rir(
        self, affix_id: bool = True, channel: Optional[Union[int, List[int]]] = None,
    ) -> "SupervisionSegment":
        return self._affixed("rvb", affix_id, channel=ifnone(channel, self.channel))

    def map(self, transform_fn: Callable[["SupervisionSegment"], "SupervisionSegment"]):
        return transform_fn(self)

    def to_dict(self) -> dict:
        if self.alignment is None:
            return asdict_nonull(self)
        alis = {kind: [item.serialize() for item in ali] for kind, ali in self.alignment.items()}
        data = asdict_nonull(fastcopy(self, alignment=None))
        data["alignment"] = alis
        return data

    @staticmethod
    def from_dict(data: dict) -> "SupervisionSegment":
        from lhotse_tpu_torch.serialization import deserialize_custom_field

        if "custom" in data:
            deserialize_custom_field(data["custom"])
        if "alignment" in data:
            data["alignment"] = {
                k: [AlignmentItem.deserialize(x) for x in v] for k, v in data["alignment"].items()}
        return SupervisionSegment(**data)
