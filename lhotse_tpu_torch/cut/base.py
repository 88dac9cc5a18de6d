"""
Cut: the abstract time-interval view over a Recording and/or Features
(copied from ``lhotse_tpu/cut/base.py``), with the operations implemented
once on the base class: ``mix``/``append``,
``trim_to_supervisions``, ``trim_to_alignments``,
``trim_to_supervision_groups``, ``cut_into_windows[_balanced]``,
``index_supervisions`` (over :class:`SupervisionIntervalIndex`) and the
supervision and per-speaker activity masks over frames and samples,
``split``, ``save_audio``, and the plotting (matplotlib) and playback
(IPython) helpers, which import their package at call time. All cut
operations are lazy and non-mutating. ``plot_alignment`` computes its
spectrogram with a fresh ``Fbank`` on ``device``: the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

import logging
import math
from bisect import bisect_left
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from lhotse_tpu_torch.audio.utils import VideoInfo
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import (
    Decibels, Pathlike, Seconds, add_durations, asdict_nonull, compute_num_samples, compute_num_windows,
    compute_start_duration_for_extended_cut, fastcopy, ifnone, overlaps, to_hashable)


class SetContainingAnything:
    def __contains__(self, item):
        return True

    def intersection(self, iterable):
        return True


class SupervisionIntervalIndex:
    """
    A minimal interval index over supervisions: sorted by start with an
    overlap query. Replaces the reference's intervaltree dependency; queries
    are O(log m + k) on sorted starts with a max-end prune.
    """

    def __init__(self, supervisions):
        items = [(s.start, s.end, s) for s in supervisions]
        items.sort(key=lambda t: (t[0], t[1]))
        self._starts = [t[0] for t in items]
        self._items = items
        # running max of ends up to each position (for pruning)
        self._max_end = []
        cur = -math.inf
        for t in items:
            cur = max(cur, t[1])
            self._max_end.append(cur)

    def overlap(self, begin: Seconds, end: Seconds):
        """All supervisions s with s.start < end and s.end > begin."""
        out = []
        hi = bisect_left(self._starts, end)
        for i in range(hi):
            s, e, item = self._items[i]
            if e > begin:
                out.append(item)
        return out

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return (item for _, _, item in self._items)


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

    @property
    def has_overlapping_supervisions(self) -> bool:
        if len(self.supervisions) < 2:
            return False
        sups = sorted(self.supervisions, key=lambda s: s.start)
        for left, right in zip(sups, sups[1:]):
            if overlaps(left, right):
                return True
        return False

    @property
    def trimmed_supervisions(self) -> List[SupervisionSegment]:
        """Supervisions clamped to the cut bounds (caution: may corrupt ASR
        transcripts whose audio extends beyond the cut)."""
        return [s.trim(self.duration) for s in self.supervisions]

    def split(self, timestamp: Seconds) -> Tuple["Cut", "Cut"]:
        """Split at ``timestamp`` (relative to cut start) into (left, right)."""
        assert 0 < timestamp < self.duration, f"0 < {timestamp} < {self.duration}"
        left = self.truncate(duration=timestamp)
        right = self.truncate(offset=timestamp)
        return left, right

    def unmix(self, tag: Optional[str] = None) -> List["Cut"]:
        """Compatibility no-op for non-mixed cuts: [self]."""
        return [self]

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

    def compute_features(self, extractor, augment_fn=None) -> np.ndarray:
        """Compute features from this cut's audio."""
        samples = self.load_audio()
        if augment_fn is not None:
            samples = augment_fn(samples, self.sampling_rate)
        return extractor.extract(samples, self.sampling_rate)

    def plot_audio(self, ax=None, **kwargs):
        """Plot the waveform with supervision spans (requires matplotlib)."""
        import matplotlib.pyplot as plt

        samples = self.load_audio().sum(axis=0)
        if ax is None:
            _, ax = plt.subplots()
        ax.plot(np.linspace(0, self.duration, len(samples)), samples)
        for supervision in self.supervisions:
            supervision = supervision.trim(self.duration)
            ax.axvspan(supervision.start, supervision.end, color="green", alpha=0.1)
        return ax

    def play_audio(self):
        from IPython.display import Audio

        samples = self.load_audio().squeeze()
        return Audio(samples, rate=self.sampling_rate)

    def plot_features(self):
        import matplotlib.pyplot as plt

        features = np.flip(self.load_features().transpose(1, 0), 0)
        return plt.matshow(features)

    def plot_alignment(self, alignment_type: str = "word", device="cuda"):
        """Display the alignment items over a fresh fbank spectrogram
        computed on ``device`` (requires matplotlib and exactly one
        supervision carrying ``alignment[alignment_type]``)."""
        import matplotlib.pyplot as plt

        from lhotse_tpu_torch.features.kaldi.extractors import Fbank, FbankConfig
        from lhotse_tpu_torch.utils import compute_num_frames

        assert len(self.supervisions) == 1, (
            "Cannot plot alignment: there has to be exactly one supervision in a Cut."
        )
        sup = self.supervisions[0]
        assert sup.alignment is not None and alignment_type in sup.alignment, (
            f"Cannot plot alignment: missing alignment field or alignment "
            f"type '{alignment_type}'"
        )

        fbank = Fbank(FbankConfig(device=device))
        sampling_rate = fbank.extractor.sampling_rate
        feats = self.resample(sampling_rate).compute_features(fbank)

        fig = plt.matshow(np.flip(feats.transpose(1, 0), 0))
        plt.title(
            f"Cut ID:{self.id}, Speaker:{sup.speaker or '<unknown>'}, "
            f"Language:{sup.language or '<unknown>'}"
        )
        plt.tick_params(
            axis="both", which="major",
            labelbottom=True, labeltop=False, bottom=True, top=False)
        for idx, item in enumerate(sup.alignment[alignment_type]):
            end_frame = compute_num_frames(
                item.end, frame_shift=fbank.frame_shift, sampling_rate=sampling_rate)
            plt.text(
                end_frame - 4, 70 if idx % 2 else 45, item.symbol,
                fontsize=12, color="w", rotation="vertical")
            plt.axvline(end_frame, color="k")
        plt.show()
        return fig

    def trim_to_supervisions(
        self, keep_overlapping: bool = True, min_duration: Optional[Seconds] = None,
        context_direction: str = "center", keep_all_channels: bool = False,
    ) -> "CutSet":  # noqa: F821
        """
        Split this cut into one cut per supervision, with the supervision's
        time bounds (optionally extended to ``min_duration`` with acoustic
        context). ``keep_overlapping=False`` guarantees exactly one
        supervision per output cut.
        """
        from lhotse_tpu_torch.cut.mixed import MixedCut
        from lhotse_tpu_torch.cut.mono import MonoCut
        from lhotse_tpu_torch.cut.multi import MultiCut
        from lhotse_tpu_torch.cut.set import CutSet

        def span_of(segment):
            if min_duration is None:
                return segment.start, segment.duration
            return compute_start_duration_for_extended_cut(
                start=segment.start, duration=segment.duration, new_duration=min_duration,
                direction=context_direction)

        def collapse_channels(piece):
            distinct = set(to_hashable(s.channel) for s in piece.supervisions)
            assert len(distinct) == 1, (
                "Trimmed cut has supervisions with different channels. Either set "
                "`keep_all_channels=True` to keep original channels or "
                "`keep_overlapping=False` to retain only 1 supervision per cut."
            )
            channel = piece.supervisions[0].channel
            if isinstance(piece, MonoCut) and isinstance(channel, list) and len(channel) == 1:
                # A MonoCut names its one channel as an int; AMI's single-microphone
                # supervisions carry a list, [0].
                channel = channel[0]
            piece.channel = channel
            if isinstance(piece, MultiCut) and piece.num_channels == 1:
                piece = piece.to_mono()[0]
            return piece

        cuts = []
        supervisions_index = self.index_supervisions(index_mixed_tracks=True)
        for segment in self.supervisions:
            begin, span = span_of(segment)
            trimmed = self.truncate(
                offset=begin, duration=span, keep_excessive_supervisions=keep_overlapping,
                _supervisions_index=supervisions_index)
            if not keep_overlapping:
                trimmed = trimmed.filter_supervisions(lambda s: s.id == segment.id)
            if not keep_all_channels and not isinstance(trimmed, MixedCut):
                trimmed = collapse_channels(trimmed)
            if len(trimmed.supervisions) == 1:
                trimmed.id = segment.id
            cuts.append(trimmed)
        return CutSet.from_cuts(cuts)

    def trim_to_alignments(
        self, type: str, max_pause: Optional[Seconds] = None,
        max_segment_duration: Optional[Seconds] = None, delimiter: str = " ",
        keep_all_channels: bool = False) -> "CutSet":  # noqa: F821
        """
        Split this cut into its alignment items of the given ``type``,
        optionally merging items separated by pauses shorter than
        ``max_pause`` up to ``max_segment_duration``.
        """
        from lhotse_tpu_torch.supervision import AlignmentItem

        pause_cap = -1.0 if max_pause is None else max_pause
        span_cap = self.duration if max_segment_duration is None else max_segment_duration

        def merge_items(alignments):
            """[(merged AlignmentItem, constituent indices)] under the caps."""
            groups = [(alignments[0], [0])]
            for i, item in enumerate(alignments[1:], start=1):
                if not item.symbol.strip():
                    continue
                head, members = groups[-1]
                mergeable = (
                    item.start - head.end <= pause_cap
                    and item.end - head.start <= span_cap
                )
                if not mergeable:
                    groups.append((item, [i]))
                    continue
                grown = AlignmentItem(
                    symbol=delimiter.join([head.symbol, item.symbol]), start=head.start,
                    duration=item.end - head.start)
                groups[-1] = (grown, members + [i])
            return groups

        new_supervisions = []
        for segment in self.supervisions:
            items = (segment.alignment or {}).get(type) or None
            if not items:
                continue
            alignments = sorted(items, key=lambda a: a.start)
            for i, (item, indices) in enumerate(merge_items(alignments)):
                new_supervisions.append(
                    SupervisionSegment(
                        id=f"{segment.id}-{i}",
                        recording_id=segment.recording_id,
                        start=item.start - self.start,
                        duration=item.duration,
                        channel=segment.channel,
                        text=item.symbol,
                        language=segment.language,
                        speaker=segment.speaker,
                        gender=segment.gender,
                        alignment={type: [alignments[j] for j in indices]},
                    )
                )

        relabeled = fastcopy(self, supervisions=new_supervisions)
        return relabeled.trim_to_supervisions(
            keep_overlapping=False, keep_all_channels=keep_all_channels)

    def trim_to_supervision_groups(self, max_pause: Seconds = 0.0) -> "CutSet":  # noqa: F821
        """
        Split into cuts covering "supervision groups" — maximal runs of
        supervisions with gaps no longer than ``max_pause``
        (cf. utterance groups, arXiv:2211.00482).
        """
        from lhotse_tpu_torch.cut.set import CutSet

        if not self.supervisions:
            return CutSet([self])
        supervisions = sorted(self.supervisions, key=lambda s: s.start)

        new_cuts = []

        def flush(group_start: Seconds, group_end: Seconds):
            span = add_durations(group_end, -group_start, sampling_rate=self.sampling_rate)
            piece = self.truncate(
                offset=group_start, duration=span, keep_excessive_supervisions=False)
            new_cuts.append(piece.with_id(f"{self.id}-{max_pause}-{len(new_cuts)}"))

        group_start = supervisions[0].start
        group_end = supervisions[0].end
        for sup in supervisions[1:]:
            if sup.start - group_end <= max_pause:
                group_end = max(group_end, sup.end)
            else:
                flush(group_start, group_end)
                group_start, group_end = sup.start, sup.end
        flush(group_start, group_end)

        assert sum(len(c.supervisions) for c in new_cuts) == len(self.supervisions), (
            "The total number of supervisions decreased after trimming to "
            "supervision groups — this is likely a bug."
        )
        return CutSet.from_cuts(new_cuts)

    def cut_into_windows_balanced(
        self, min_duration: Seconds, max_duration: Seconds, overlap: Seconds = 0.0,
        keep_excessive_supervisions: bool = True) -> "CutSet":  # noqa: F821
        """
        Split into overlapping windows whose size is chosen within
        [min_duration, max_duration] to maximize the final window's length
        (minimizing padding). Each sub-cut records ``source_cut_id`` and
        ``source_cut_start`` in its custom dict.
        """
        from lhotse_tpu_torch.cut.set import CutSet

        if self.duration <= max_duration:
            return CutSet.from_cuts([self])

        best_duration = min_duration
        best_last_chunk = 0.0
        for d in range(math.floor(min_duration), math.floor(max_duration) + 1):
            hop = d - overlap
            if hop <= 0 or d > self.duration:
                continue
            n_chunks = math.ceil(self.duration / hop)
            last_start = hop * (n_chunks - 1)
            last_chunk_len = self.duration - last_start
            if last_chunk_len > best_last_chunk:
                best_last_chunk = last_chunk_len
                best_duration = float(d)

        origin = {"source_cut_id": self.id, "source_cut_start": self.start}
        windows = [
            fastcopy(sub, custom={**(sub.custom or {}), **origin})
            for sub in self._windows(
                best_duration, best_duration - overlap, keep_excessive_supervisions
            )
        ]
        return CutSet.from_cuts(windows)

    def _windows(self, duration: Seconds, hop: Seconds, keep_excessive_supervisions: bool):
        supervisions_index = self.index_supervisions(index_mixed_tracks=True)
        for i in range(compute_num_windows(self.duration, duration, hop)):
            yield self.truncate(
                offset=hop * i, duration=duration,
                keep_excessive_supervisions=keep_excessive_supervisions,
                _supervisions_index=supervisions_index).with_id(f"{self.id}-{i}")

    def cut_into_windows(
        self, duration: Seconds, hop: Optional[Seconds] = None,
        keep_excessive_supervisions: bool = True) -> "CutSet":  # noqa: F821
        """Split into windows of ``duration`` every ``hop`` seconds (the last
        window may be shorter)."""
        from lhotse_tpu_torch.cut.set import CutSet

        if not hop:
            hop = duration
        if self.has_video:
            assert (duration * self.video.fps).is_integer(), (
                f"[cut.id={self.id}] Window duration must give an integer number "
                f"of video frames (duration={duration} * fps={self.video.fps})."
            )
            assert (hop * self.video.fps).is_integer(), (
                f"[cut.id={self.id}] Window hop must give an integer number of "
                f"video frames (hop={hop} * fps={self.video.fps})."
            )
        return CutSet.from_cuts(self._windows(duration, hop, keep_excessive_supervisions))

    def index_supervisions(
        self, index_mixed_tracks: bool = False, keep_ids: Optional[Set[str]] = None,
    ) -> Dict[str, SupervisionIntervalIndex]:
        """Index {cut_id: interval index of its supervisions} to speed up
        repeated truncations of long cuts. With ``index_mixed_tracks`` the
        tracks of a ``MixedCut`` are indexed too, and the tracks of a track
        that is itself a ``MixedCut`` (a simulated meeting's speaker track),
        which its truncation looks up; the JAX package indexes one level and
        raises ``KeyError`` when windowing such a meeting."""
        from lhotse_tpu_torch.cut.mixed import MixedCut

        keep_ids = ifnone(keep_ids, SetContainingAnything())
        indexed = {
            self.id: SupervisionIntervalIndex(
                s for s in self.supervisions if s.id in keep_ids and s.duration > 0
            )
        }
        if index_mixed_tracks and isinstance(self, MixedCut):
            for track in self.tracks:
                indexed.update(track.cut.index_supervisions(
                    index_mixed_tracks=True, keep_ids=keep_ids))
        return indexed

    def save_audio(
        self, storage_path: Pathlike, format: Optional[str] = None, encoding: Optional[str] = None,
        augment_fn=None, **kwargs) -> "Cut":
        """Store this cut's waveform to disk and return a new Cut referencing
        the stored recording, which is named after the file. The
        supervisions are pointed at it (the JAX package keeps their old
        ``recording_id``, which ``validate`` refuses: ROADMAP C2). The new
        cut starts at 0 of the stored recording; where this cut did not,
        its features, temporal arrays and custom recordings (except those
        marked ``{name}_unaligned``) are read from the old recording's
        timeline, so they are dropped with a warning (the JAX package keeps
        them, and they then read another window: ROADMAP C2). ``CutSet.copy_data`` stores their windows with the audio."""
        from lhotse_tpu_torch.array import TemporalArray
        from lhotse_tpu_torch.audio import AudioSource, Recording
        from lhotse_tpu_torch.audio.backend import save_audio

        storage_path = Path(storage_path)
        samples = self.load_audio(**kwargs)
        if augment_fn is not None:
            samples = augment_fn(samples, self.sampling_rate)
        save_audio(
            storage_path, samples, sampling_rate=self.sampling_rate, format=format,
            encoding=encoding)
        n = samples.shape[1]
        source = AudioSource(
            type="file", channels=list(range(self.num_channels)), source=str(storage_path))
        stored = Recording(
            id=storage_path.stem, sampling_rate=self.sampling_rate, num_samples=n,
            duration=n / self.sampling_rate, sources=[source])
        features = self.features if self.has_features else None
        custom = getattr(self, "custom", None)
        if self.start != 0:
            timed = [k for k, v in (custom or {}).items() if isinstance(v, TemporalArray) or (
                isinstance(v, Recording) and not custom.get(f"{k}_unaligned", False))]
            dropped = ["features"] * (features is not None) + timed
            if dropped:
                logging.warning(
                    f"Cut {self.id} starts at {self.start} s of its recording: its {dropped} "
                    f"cannot follow it to the stored audio, which starts at 0, and are dropped.")
            features = None
            if custom is not None:
                custom = {k: v for k, v in custom.items() if k not in timed} or None
        return fastcopy(
            stored.to_cut(), id=self.id,
            supervisions=[fastcopy(s, recording_id=stored.id) for s in self.supervisions],
            custom=custom, features=features)

    def _active_spans(self, supervision, use_alignment_if_exists: Optional[str]):
        """(start, end) second-spans of activity: the alignment items when the
        requested alignment exists, otherwise the whole supervision."""
        ali = (supervision.alignment or {}).get(use_alignment_if_exists or "", None)
        if use_alignment_if_exists and ali is not None:
            return [(item.start, item.end) for item in ali]
        return [(supervision.start, supervision.end)]

    def _speaker_rows(self, speaker_to_idx_map, min_speaker_dim):
        if speaker_to_idx_map is None:
            speakers = sorted(set(s.speaker for s in self.supervisions))
            speaker_to_idx_map = {spk: idx for idx, spk in enumerate(speakers)}
        rows = len(speaker_to_idx_map)
        if min_speaker_dim is not None:
            # At least ``min_speaker_dim`` rows, as documented (CHiME-6 always
            # wants 4), as in the JAX package.
            rows = max(min_speaker_dim, rows)
        return speaker_to_idx_map, rows

    def _speakers_activity_mask(
        self, num_units: int, to_unit, speaker_to_idx_map, min_speaker_dim, use_alignment_if_exists,
    ) -> np.ndarray:
        """Shared (num_speakers, num_units) activity rasterizer; ``to_unit``
        converts seconds to the frame/sample grid."""
        speaker_to_idx_map, rows = self._speaker_rows(speaker_to_idx_map, min_speaker_dim)
        mask = np.zeros((rows, num_units))
        for supervision in self.supervisions:
            row = speaker_to_idx_map[supervision.speaker]
            for begin, finish in self._active_spans(supervision, use_alignment_if_exists):
                lo = to_unit(begin) if begin > 0 else 0
                hi = to_unit(finish) if finish < self.duration else num_units
                mask[row, lo:hi] = 1
        return mask

    def speakers_feature_mask(
        self, min_speaker_dim: Optional[int] = None,
        speaker_to_idx_map: Optional[Dict[str, int]] = None,
        use_alignment_if_exists: Optional[str] = None) -> np.ndarray:
        """(num_speakers, num_frames) 0/1 per-speaker activity matrix
        (TS-VAD-style; arXiv:2005.07272)."""
        assert self.has_features, (
            f"No features available. Can't compute speakers feature mask for cut {self.id}."
        )
        return self._speakers_activity_mask(
            self.num_frames, lambda secs: round(secs / self.frame_shift), speaker_to_idx_map,
            min_speaker_dim, use_alignment_if_exists)

    def speakers_audio_mask(
        self, min_speaker_dim: Optional[int] = None,
        speaker_to_idx_map: Optional[Dict[str, int]] = None,
        use_alignment_if_exists: Optional[str] = None) -> np.ndarray:
        """(num_speakers, num_samples) 0/1 per-speaker activity matrix."""
        assert self.has_recording, (
            f"No recording available. Can't compute speakers audio mask for cut {self.id}."
        )
        return self._speakers_activity_mask(
            compute_num_samples(self.duration, self.sampling_rate),
            lambda secs: compute_num_samples(secs, self.sampling_rate), speaker_to_idx_map,
            min_speaker_dim, use_alignment_if_exists)

    def supervisions_feature_mask(self, use_alignment_if_exists: Optional[str] = None) -> np.ndarray:
        """1-D 0/1 mask over frames covered by at least one supervision."""
        from lhotse_tpu_torch.cut.set import compute_supervisions_frame_mask

        return compute_supervisions_frame_mask(
            self, use_alignment_if_exists=use_alignment_if_exists)

    def supervisions_audio_mask(self, use_alignment_if_exists: Optional[str] = None) -> np.ndarray:
        """1-D 0/1 mask over samples covered by at least one supervision."""
        assert self.has_recording, (
            f"No recording available. Can't compute supervisions audio mask for cut {self.id}."
        )
        mask = np.zeros(self.num_samples, dtype=np.float32)
        cap = round(self.duration * self.sampling_rate)
        for supervision in self.supervisions:
            for begin, finish in self._active_spans(supervision, use_alignment_if_exists):
                lo = round(begin * self.sampling_rate) if begin > 0 else 0
                hi = round(finish * self.sampling_rate) if finish < self.duration else cap
                mask[lo:hi] = 1.0
        return mask

    def with_id(self, id_: str) -> "Cut":
        """Return a copy of the Cut with a new ID."""
        return fastcopy(self, id=id_)
