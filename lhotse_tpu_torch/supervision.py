"""
SupervisionSegment and SupervisionSet: segment-level annotations (copied
from ``lhotse_tpu/supervision.py``), with ``AlignmentItem``, the mirrors of
the cut perturbations (speed, tempo, volume, reverb), trimming, text and
alignment transforms, and the set's cached ``find()`` temporal search,
RTTM import and CTM import/export.
"""
from __future__ import annotations

import logging
from collections import defaultdict
from dataclasses import dataclass
from itertools import islice
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Union

from lhotse_tpu_torch.custom import CustomFieldMixin
from lhotse_tpu_torch.lazy import AlgorithmMixin
from lhotse_tpu_torch.serialization import Serializable
from lhotse_tpu_torch.utils import (
    Pathlike, Seconds, TimeSpan, add_durations, asdict_nonull, compute_num_samples,
    exactly_one_not_null, fastcopy, ifnone, is_equal_or_contains, overspans, perturb_num_samples,
    split_manifest_lazy, split_sequence)


# Alignment times are quantized against a 48 kHz grid: fine enough for any
# supported audio rate while keeping add_durations() exact.
_TIME_GRID_SR = 48000


def _rescaled_span(start: Seconds, duration: Seconds, factor: float, sampling_rate: int):
    """(start, duration) after speed/tempo scaling by ``factor`` (exact
    sample-count arithmetic, like the audio itself)."""
    begin = perturb_num_samples(compute_num_samples(start, sampling_rate), factor)
    span = perturb_num_samples(compute_num_samples(duration, sampling_rate), factor)
    return begin / sampling_rate, span / sampling_rate


def _clamped_span(item, lo: Seconds, hi: Seconds):
    """(start, duration) of ``item`` clamped into the [lo, hi] window."""
    assert lo >= 0
    head_loss = abs(min(0, item.start - lo))
    tail_loss = max(0, item.end - hi)
    clamped = add_durations(item.duration, -tail_loss, -head_loss, sampling_rate=_TIME_GRID_SR)
    return max(lo, item.start), clamped


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

    def trim(self, end: Seconds, start: Seconds = 0) -> "AlignmentItem":
        begin, span = _clamped_span(self, start, end)
        return AlignmentItem(symbol=self.symbol, start=begin, duration=span)

    def transform(self, transform_fn: Callable[[str], str]) -> "AlignmentItem":
        return self._replace(symbol=transform_fn(self.symbol))


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

    def narrowband(self, codec: str, affix_id: bool = True) -> "SupervisionSegment":
        return self._affixed(f"nb_{codec}", affix_id)

    def reverb_rir(
        self, affix_id: bool = True, channel: Optional[Union[int, List[int]]] = None,
    ) -> "SupervisionSegment":
        return self._affixed("rvb", affix_id, channel=ifnone(channel, self.channel))

    def trim(self, end: Seconds, start: Seconds = 0) -> "SupervisionSegment":
        """
        Clamp the segment to [start, end] (both relative to the same reference
        as ``self.start``); useful to keep supervisions within a cut's bounds.
        """
        begin, span = _clamped_span(self, start, end)
        return fastcopy(
            self, start=begin, duration=span,
            alignment=self._map_alignment(lambda item: item.trim(end=end, start=start)))

    def map(self, transform_fn: Callable[["SupervisionSegment"], "SupervisionSegment"]):
        return transform_fn(self)

    def transform_text(self, transform_fn: Callable[[str], str]) -> "SupervisionSegment":
        if self.text is None:
            return self
        return fastcopy(self, text=transform_fn(self.text))

    def transform_alignment(
        self, transform_fn: Callable[[str], str], type: Optional[str] = "word",
    ) -> "SupervisionSegment":
        if self.alignment is None:
            return self
        return fastcopy(
            self,
            alignment={ ali_type: [ item.transform(transform_fn=transform_fn) if ali_type == type else item for item in ali ] for ali_type, ali in self.alignment.items() },
        )

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


class SupervisionSet(Serializable, AlgorithmMixin):
    """
    A collection of :class:`SupervisionSegment` (eager list or lazy iterable)
    with serialization, splitting/subsetting, temporal ``find()`` search, and
    RTTM/CTM interop. Think of it as Kaldi's ``segments`` + ``text`` +
    ``utt2spk`` combined.
    """

    def __init__(self, segments: Optional[Iterable[SupervisionSegment]] = None) -> None:
        self.segments = ifnone(segments, {})
        self._segments_by_recording_id: Optional[Dict[str, List[SupervisionSegment]]] = None

    def __eq__(self, other: "SupervisionSet") -> bool:
        return self.segments == other.segments

    @property
    def data(self) -> Union[Dict[str, SupervisionSegment], Iterable[SupervisionSegment]]:
        return self.segments

    @property
    def ids(self) -> Iterable[str]:
        return (s.id for s in self)

    @staticmethod
    def from_segments(segments: Iterable[SupervisionSegment]) -> "SupervisionSet":
        return SupervisionSet(list(segments))

    from_items = from_segments

    @staticmethod
    def from_dicts(data: Iterable[Dict]) -> "SupervisionSet":
        return SupervisionSet.from_segments(SupervisionSegment.from_dict(s) for s in data)

    @staticmethod
    def from_rttm(path: Union[Pathlike, Iterable[Pathlike]]) -> "SupervisionSet":
        """Read RTTM file(s) — one SPEAKER turn per line — into supervisions."""
        files = [path] if isinstance(path, (Path, str)) else path

        def turns():
            for file in files:
                for idx, line in enumerate(Path(file).read_text().splitlines()):
                    fields = line.split()
                    assert len(fields) == 10, (f"Invalid RTTM line in file {file}: {line}\n")
                    _, reco, ch, begin, span, _, _, spk, _, _ = fields
                    if float(span) == 0:
                        continue  # zero-length turns carry no information
                    yield SupervisionSegment(
                        id=f"{reco}-{idx:06d}", recording_id=reco, channel=int(ch),
                        start=float(begin), duration=float(span), speaker=spk)

        return SupervisionSet.from_segments(turns())

    def with_alignment_from_ctm(
        self, ctm_file: Pathlike, type: str = "word", match_channel: bool = False,
        verbose: bool = False) -> "SupervisionSet":
        """Attach alignments read from a CTM file to matching segments."""
        def maybe_progress(iterable, desc):
            if not verbose:
                return iterable
            from tqdm.auto import tqdm

            return tqdm(iterable, desc=desc)

        # reco_id -> [(channel, AlignmentItem)], time-sorted.
        per_reco: Dict[str, list] = defaultdict(list)
        num_total = 0
        with open(ctm_file) as f:
            for line in maybe_progress(f, "Reading words from CTM file"):
                reco_id, ch, begin, span, symbol, *score = line.strip().split()
                item = AlignmentItem(
                    symbol=symbol, start=float(begin), duration=float(span),
                    score=float(score[0]) if score else None)
                per_reco[reco_id].append((int(ch), item))
                num_total += 1
        for rows in per_reco.values():
            rows.sort(key=lambda pair: pair[1].start)

        segments = []
        num_attached = 0
        reco_ids = set(s.recording_id for s in self)
        for reco_id in maybe_progress(reco_ids, "Adding alignments"):
            words = per_reco.get(reco_id, [])
            for seg in self.find(recording_id=reco_id):
                alignment = [
                    item
                    for ch, item in words
                    if overspans(seg, TimeSpan(item.start, item.start + item.duration))
                    and (not match_channel or seg.channel == ch)
                ]
                num_attached += len(alignment)
                segments.append(fastcopy(seg, alignment={type: alignment}))
        logging.info(
            f"{num_attached} alignments added out of {num_total} total. "
            "If many are missing, there may be a mismatch problem."
        )
        return SupervisionSet.from_segments(segments)

    def write_alignment_to_ctm(self, ctm_file: Pathlike, type: str = "word") -> None:
        """Write alignments of the given type to a CTM file."""
        with open(ctm_file, "w") as f:
            for s in self:
                if type not in s.alignment:
                    continue
                ch = s.channel[0] if isinstance(s.channel, list) else s.channel
                for ali in s.alignment[type]:
                    fields = [
                        s.recording_id, str(ch), f"{ali.start:.02f}", f"{ali.duration:.02f}",
                        ali.symbol]
                    if ali.score is not None:
                        fields.append(f"{ali.score:.02f}")
                    print(" ".join(fields), file=f)

    def to_dicts(self) -> Iterable[dict]:
        return (s.to_dict() for s in self)

    def split(
        self, num_splits: int, shuffle: bool = False, drop_last: bool = False,
    ) -> List["SupervisionSet"]:
        """Split into ``num_splits`` pieces of (near-)equal size."""
        return [
            SupervisionSet.from_segments(subset)
            for subset in split_sequence(
                self, num_splits=num_splits, shuffle=shuffle, drop_last=drop_last
            )
        ]

    def split_lazy(
        self, output_dir: Pathlike, chunk_size: int, prefix: str = "") -> List["SupervisionSet"]:
        """Split into fixed-size chunks saved to disk as the input is consumed."""
        return split_manifest_lazy(
            self, output_dir=output_dir, chunk_size=chunk_size, prefix=prefix)

    def subset(self, first: Optional[int] = None, last: Optional[int] = None) -> "SupervisionSet":
        """Keep only the first or last N segments."""
        assert exactly_one_not_null(first, last), "subset() can handle only one non-None arg."
        if first is not None:
            assert first > 0
            return SupervisionSet.from_items(islice(self, first))
        if last is not None:
            assert last > 0
            if last > len(self):
                return self
            return SupervisionSet.from_segments(islice(self, len(self) - last, len(self)))

    def transform_text(self, transform_fn: Callable[[str], str]) -> "SupervisionSet":
        return SupervisionSet.from_segments(s.transform_text(transform_fn) for s in self)

    def transform_alignment(
        self, transform_fn: Callable[[str], str], type: str = "word") -> "SupervisionSet":
        return SupervisionSet.from_segments(
            s.transform_alignment(transform_fn, type=type) for s in self
        )

    def find(
        self, recording_id: str, channel: Optional[int] = None, start_after: Seconds = 0,
        end_before: Optional[Seconds] = None, adjust_offset: bool = False,
        tolerance: Seconds = 0.001) -> Iterable[SupervisionSegment]:
        """
        Temporal search over segments of ``recording_id`` (cached index),
        optionally restricted to a channel and a [start_after, end_before]
        window; ``adjust_offset`` re-bases starts to ``start_after`` (useful
        when creating Cuts). Reference: supervision.py:813.
        """
        segment_by_recording_id = self._index_by_recording_id_and_cache()
        return (
            segment.with_offset(-start_after) if adjust_offset else segment
            for segment in segment_by_recording_id.get(recording_id, [])
            if (channel is None or is_equal_or_contains(segment.channel, channel))
            and segment.start >= start_after - tolerance
            and (end_before is None or segment.end <= end_before + tolerance)
        )

    def _index_by_recording_id_and_cache(self):
        if self._segments_by_recording_id is None:
            index: Dict[str, List[SupervisionSegment]] = defaultdict(list)
            for seg in self:
                index[seg.recording_id].append(seg)
            self._segments_by_recording_id = dict(index)
        return self._segments_by_recording_id

    def __repr__(self) -> str:
        return f"SupervisionSet(len={len(self)})"

    def __getitem__(self, index_or_id: Union[int, str]) -> SupervisionSegment:
        try:
            return self.segments[index_or_id]
        except TypeError:
            # Lazy backend: strings match by id, ints by iteration position.
            if isinstance(index_or_id, str):
                try:
                    return next(item for item in self if item.id == index_or_id)
                except StopIteration:
                    raise KeyError(index_or_id) from None
            try:
                return next(
                    item for idx, item in enumerate(self) if idx == index_or_id
                )
            except StopIteration:
                raise IndexError(index_or_id) from None

    def __contains__(self, other: Union[str, SupervisionSegment]) -> bool:
        if isinstance(other, str):
            return any(other == item.id for item in self)
        return any(other.id == item.id for item in self)

    def __iter__(self) -> Iterable[SupervisionSegment]:
        yield from self.segments

    def __len__(self) -> int:
        return len(self.segments)
