"""
RecordingSet: a collection of Recordings, eager list or lazy iterable
(copied from ``lhotse_tpu/audio/recording_set.py``): dict-like access,
``from_dir`` scanning (in spawned processes with ``num_jobs > 1``), the
split/subset/filter/map combinators, and the whole-set perturbation,
resampling and reverberation builders.
"""
from __future__ import annotations

import re
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from itertools import islice
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Union

import numpy as np

from lhotse_tpu_torch.audio.recording import Recording
from lhotse_tpu_torch.lazy import AlgorithmMixin
from lhotse_tpu_torch.serialization import Serializable
from lhotse_tpu_torch.utils import (
    Channels, Pathlike, exactly_one_not_null, ifnone, split_manifest_lazy, split_sequence)


def _file_read_worker(
    p: Path, force_opus_sampling_rate: Optional[int] = None,
    recording_id: Optional[Callable[[Path], str]] = None) -> Recording:
    return Recording.from_file(
        p, force_opus_sampling_rate=force_opus_sampling_rate, recording_id=recording_id)


class RecordingSet(Serializable, AlgorithmMixin):
    """
    A collection of recordings: think of it as ``wav.scp`` on steroids — it
    also carries durations/sample counts, multi-channel info, and supports
    reading audio from files, pipes, and URLs.
    """

    def __init__(self, recordings: Optional[Iterable[Recording]] = None) -> None:
        self.recordings = ifnone(recordings, {})

    def __eq__(self, other: "RecordingSet") -> bool:
        return self.recordings == other.recordings

    data = property(lambda self: self.recordings)
    ids = property(lambda self: (r.id for r in self))

    @staticmethod
    def from_recordings(recordings: Iterable[Recording]) -> "RecordingSet":
        return RecordingSet(list(recordings))

    from_items = from_recordings

    @staticmethod
    def from_dir(
        path: Pathlike, pattern: str, num_jobs: int = 1,
        force_opus_sampling_rate: Optional[int] = None,
        recording_id: Optional[Callable[[Path], str]] = None, exclude_pattern: Optional[str] = None,
    ):
        """
        Recursively scan ``path`` for audio files matching ``pattern`` and
        build a RecordingSet (header-only probes; parallel with num_jobs > 1).
        """
        path = Path(path)
        it = path.rglob(pattern)
        if exclude_pattern is not None:
            exclude = re.compile(exclude_pattern)
            it = (p for p in it if exclude.fullmatch(p.name) is None)
        worker = partial(
            _file_read_worker, force_opus_sampling_rate=force_opus_sampling_rate,
            recording_id=recording_id)
        if num_jobs == 1:
            recs = map(worker, it)
        else:
            # Spawned, not forked: the caller may have a CUDA context.
            with ProcessPoolExecutor(num_jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
                recs = list(ex.map(worker, it))
        # Sort by the DERIVED recording id (not the path: rglob order varies
        # between hosts, and nested layouts / custom recording_id functions
        # make path order diverge from id order), so downstream streaming
        # joins get their sorted-by-recording-id contract.
        return RecordingSet.from_recordings(sorted(recs, key=lambda r: r.id))

    @staticmethod
    def from_dicts(data: Iterable[dict]) -> "RecordingSet":
        return RecordingSet.from_recordings(Recording.from_dict(raw) for raw in data)

    def to_dicts(self) -> Iterable[dict]:
        return (r.to_dict() for r in self)

    def split(
        self, num_splits: int, shuffle: bool = False, drop_last: bool = False,
    ) -> List["RecordingSet"]:
        """Split into ``num_splits`` pieces of (near-)equal size."""
        pieces = split_sequence(self, num_splits=num_splits, shuffle=shuffle, drop_last=drop_last)
        return [RecordingSet.from_recordings(piece) for piece in pieces]

    def split_lazy(
        self, output_dir: Pathlike, chunk_size: int, prefix: str = "") -> List["RecordingSet"]:
        """Split into fixed-size chunks saved to disk as the input is consumed."""
        return split_manifest_lazy(
            self, output_dir=output_dir, chunk_size=chunk_size, prefix=prefix)

    def subset(self, first: Optional[int] = None, last: Optional[int] = None) -> "RecordingSet":
        """Keep only the first or last N recordings."""
        assert exactly_one_not_null(first, last), "subset() can handle only one non-None arg."
        if first is not None:
            assert first > 0
            return RecordingSet.from_items(islice(self, first))
        if last is not None:
            assert last > 0
            if last > len(self):
                return self
            return RecordingSet.from_recordings(islice(self, len(self) - last, len(self)))

    def load_audio(
        self, recording_id: str, channels: Optional[Channels] = None, offset_seconds: float = 0.0,
        duration_seconds: Optional[float] = None) -> np.ndarray:
        rec = self[recording_id]
        return rec.load_audio(channels=channels, offset=offset_seconds, duration=duration_seconds)

    def with_path_prefix(self, path: Pathlike) -> "RecordingSet":
        return RecordingSet.from_recordings(r.with_path_prefix(path) for r in self)

    # Per-recording metadata lookups (wav.scp-style convenience accessors).
    num_channels = lambda self, recording_id: self[recording_id].num_channels
    sampling_rate = lambda self, recording_id: self[recording_id].sampling_rate
    num_samples = lambda self, recording_id: self[recording_id].num_samples
    duration = lambda self, recording_id: self[recording_id].duration

    def perturb_speed(self, factor: float, affix_id: bool = True) -> "RecordingSet":
        """Lazy whole-set speed perturbation."""
        return RecordingSet.from_recordings(
            r.perturb_speed(factor=factor, affix_id=affix_id) for r in self
        )

    def perturb_tempo(self, factor: float, affix_id: bool = True) -> "RecordingSet":
        """Lazy whole-set tempo perturbation."""
        return RecordingSet.from_recordings(
            r.perturb_tempo(factor=factor, affix_id=affix_id) for r in self
        )

    def perturb_volume(self, factor: float, affix_id: bool = True) -> "RecordingSet":
        """Lazy whole-set volume perturbation."""
        return RecordingSet.from_recordings(
            r.perturb_volume(factor=factor, affix_id=affix_id) for r in self
        )

    def reverb_rir(
        self, rir_recordings: Optional["RecordingSet"] = None, normalize_output: bool = True,
        early_only: bool = False, affix_id: bool = True, rir_channels: List[int] = [0],
        room_rng_seed: Optional[int] = None, source_rng_seed: Optional[int] = None,
    ) -> "RecordingSet":
        """Lazy whole-set reverberation with RIRs sampled round-robin (or
        synthetic RIRs when none given; the rng seeds control the synthetic
        room configuration / source position, reference:
        audio/recording_set.py:318)."""
        import random

        rirs = list(rir_recordings) if rir_recordings is not None else None
        return RecordingSet.from_recordings(
            r.reverb_rir(
                rir_recording=random.choice(rirs) if rirs else None,
                normalize_output=normalize_output,
                early_only=early_only,
                affix_id=affix_id,
                rir_channels=rir_channels,
                room_rng_seed=room_rng_seed,
                source_rng_seed=source_rng_seed,
            )
            for r in self
        )

    def resample(self, sampling_rate: int) -> "RecordingSet":
        """Lazy whole-set resampling."""
        return RecordingSet.from_recordings(r.resample(sampling_rate) for r in self)

    def __repr__(self) -> str:
        return f"RecordingSet(len={len(self)})"

    def __getitem__(self, index_or_id: Union[int, str]) -> Recording:
        try:
            return self.recordings[index_or_id]
        except TypeError:
            # Lazy backend (or eager int lookup fell through): strings match
            # by item id, ints by iteration position.
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

    def __contains__(self, other: Union[str, Recording]) -> bool:
        if isinstance(other, str):
            return any(other == item.id for item in self)
        return any(other.id == item.id for item in self)

    def __iter__(self) -> Iterable[Recording]:
        yield from self.recordings

    def __len__(self) -> int:
        return len(self.recordings)
