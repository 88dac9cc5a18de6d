"""
CutSet: the eager or lazy collection of cuts (copied from
``lhotse_tpu/cut/set.py``), with the part of its algebra the data path
uses: construction from cuts, lazy JSONL and the Recording, Supervision and
Feature manifests (``from_manifests``: eager, or a single forward scan over
inputs sorted by recording id that writes the cuts as it goes), ``filter``,
``map``, ``shuffle``, ``repeat``, ``subset``, ``split``, ``modify_ids``,
``sort_by_duration``, ``sort_by_recording_id``, ``+``, checkpointing of the
lazy graph, the one-to-many operations (``trim_to_supervisions``,
``trim_to_alignments``, ``trim_to_supervision_groups``,
``trim_to_unsupervised_segments``, ``cut_into_windows[_balanced]``, lazy or
fanned out over spawned processes), supervision merging, filling, mapping
and text transforms, ``index_supervisions``, ``decompose``, ``describe``,
``compute_global_feature_stats``, the path prefixes, feature extraction and
storage (``compute_and_store_features``, single-process or fanned out over
spawned processes, and ``compute_and_store_features_batch``), the
``drop_*`` methods, the supervisions' frame mask, the lazy augmentation
operations (``pad``, ``truncate``, ``extend_by``, ``resample``,
``perturb_speed``, ``perturb_tempo``, ``perturb_volume``, ``reverb_rir``,
``mix`` through :class:`LazyCutMixer`, sequential or, over indexed sources
and noise, with per-item RNGs, constant-time access and checkpoints), the
Shar format (``from_shar``, streaming or indexed, and ``to_shar``, in one
process or over ``split_lazy`` chunks in spawned processes) and the module
functions ``mix``, ``pad``, ``append``, ``mix_cuts`` and ``append_cuts``.

Multi-channel recordings and feature manifests become ``MultiCut``s in
``from_manifests``; ``combine_same_recording_channels`` joins per-channel
cuts of one span into them, and ``dereverb_wpe`` applies the host WPE
transform lazily. ``compute_and_store_features_batch`` takes one channel per
cut: a multi-channel cut raises there, where the JAX package joins its
channels in time (use ``compute_and_store_features``, which stores one
``(C, T, F)`` matrix per cut).

Many manifest files read as one lazy set through ``from_files`` (with
item-level Feistel shuffling when every file has an ``.idx`` sidecar), and
WebDataset tarballs through ``from_webdataset``.

``copy_feats`` re-stores every feature matrix through another writer;
``save_audios`` stores each cut's waveform under ``{id[:3]}/{id}.{format}``
(in one process or over spawned processes), ``copy_data`` copies every
referenced audio file, feature matrix and custom array into one directory,
and ``prefetch`` reads ahead in a bounded background thread. The
HuggingFace bridges (``to_huggingface_dataset``,
``from_huggingface_dataset``) need the ``datasets`` package
(:mod:`lhotse_tpu_torch.hf`).
"""
from __future__ import annotations

import hashlib
import itertools
import logging
import pickle
import random
import warnings
from collections import defaultdict
from concurrent.futures import Executor, ProcessPoolExecutor, as_completed
from functools import partial, reduce
from itertools import chain, islice
from pathlib import Path
from typing import (
    Any, Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple, Type,
    TypeVar, Union)

import numpy as np

from lhotse_tpu_torch.audio import RecordingSet, null_result_on_audio_loading_error
from lhotse_tpu_torch.cut.base import Cut
from lhotse_tpu_torch.cut.data import DataCut
from lhotse_tpu_torch.cut.mixed import MixedCut, MixTrack, _ensure_explicit_snr_reference
from lhotse_tpu_torch.cut.mono import MonoCut
from lhotse_tpu_torch.cut.multi import MultiCut
from lhotse_tpu_torch.cut.padding import PaddingCut
from lhotse_tpu_torch.features.base import (
    FeatureExtractor, Features, FeatureSet, StatsAccumulator, compute_global_stats)
from lhotse_tpu_torch.features.io import (
    FeaturesWriter, LilcomChunkyWriter, default_features_storage_backend)
from lhotse_tpu_torch.lazy import (
    AlgorithmMixin, IteratorNode, LazyFlattener, LazyMapper, LazySlicer, _restore_child,
    _snapshot_child, attach_graph_origin, get_graph_origin, is_dill_enabled,
    normalize_graph_token, resolve_iterator_source, supports_graph_restore)
from lhotse_tpu_torch.serialization import Serializable
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import (
    LOG_EPSILON, Decibels, Pathlike, Seconds, compute_num_frames, compute_num_samples,
    exactly_one_not_null, fastcopy, ifnone, split_manifest_lazy, split_sequence, uuid4)

T = TypeVar("T")
FW = TypeVar("FW", bound=FeaturesWriter)


def _progressbar(enabled: bool, **tqdm_kwargs):
    """A tqdm wrapper factory, or identity when progress is disabled."""
    if not enabled:
        return lambda x: x
    from tqdm.auto import tqdm

    return partial(tqdm, **tqdm_kwargs)


def is_cut(example) -> bool:
    return isinstance(example, (MonoCut, MultiCut, MixedCut, PaddingCut))


class CutSet(Serializable, AlgorithmMixin):
    """
    A collection of cuts (eager list or lazy iterator graph), with the part
    of the data-prep algebra the data path uses and exact checkpointing.
    """

    def __init__(self, cuts: Optional[Iterable[Cut]] = None) -> None:
        self.cuts = ifnone(cuts, [])

    def __eq__(self, other: "CutSet") -> bool:
        return self.cuts == other.cuts

    data = property(lambda self: self.cuts)

    def _only(self, cut_type) -> "CutSet":
        return CutSet([c for c in self.cuts if isinstance(c, cut_type)])

    mixed_cuts = property(lambda self: self._only(MixedCut))
    multi_cuts = property(lambda self: self._only(MultiCut))
    ids = property(lambda self: (c.id for c in self.cuts))

    @staticmethod
    def from_files(
        paths: List[Pathlike], shuffle_iters: bool = True, seed: Optional[int] = None,
        indexed: Optional[bool] = None, index_path: Optional[List[Pathlike]] = None) -> "CutSet":
        """
        One lazy CutSet over many manifest files. With ``shuffle_iters`` the
        file order is re-randomized every iteration; when every file is
        indexed, shuffling upgrades to item-level via the Feistel permutation.
        """
        from lhotse_tpu_torch.indexing import index_exists
        from lhotse_tpu_torch.lazy import (
            LazyIndexedManifestIterator, LazyIteratorChain, LazyManifestIterator)
        from lhotse_tpu_torch.serialization import extension_contains

        if index_path is not None and len(index_path) != len(paths):
            raise ValueError(
                f"index_path has {len(index_path)} entries but paths has "
                f"{len(paths)} entries — they must match."
            )
        sidecars = index_path if index_path is not None else [None] * len(paths)

        def leaf_for(path, sidecar):
            want_indexed = indexed is True or (indexed is None and sidecar is not None)
            if not want_indexed and indexed is None:
                # Auto-detect: uncompressed jsonl with an existing .idx.
                want_indexed = not extension_contains(".gz", path) and index_exists(path)
                sidecar = None
            if want_indexed:
                return LazyIndexedManifestIterator(path, index_path=sidecar)
            return LazyManifestIterator(path)

        return CutSet(
            LazyIteratorChain(
                *(leaf_for(p, sc) for p, sc in zip(paths, sidecars)), shuffle_iters=shuffle_iters,
                seed=seed,
            )
        )

    @staticmethod
    def from_cuts(cuts: Iterable[Cut]) -> "CutSet":
        return CutSet(list(cuts))

    from_items = from_cuts

    @staticmethod
    def from_manifests(
        recordings: Optional[RecordingSet] = None, supervisions: Optional[SupervisionSet] = None,
        features: Optional[FeatureSet] = None, output_path: Optional[Pathlike] = None,
        random_ids: bool = False, tolerance: Seconds = 0.001, lazy: bool = False) -> "CutSet":
        """
        Create a CutSet from any combination of recording/supervision/feature
        manifests (at least one of recordings/features required). Cut
        boundaries follow features when available, else recordings.
        """
        if lazy:
            return create_cut_set_lazy(
                recordings=recordings, supervisions=supervisions, features=features,
                output_path=output_path, random_ids=random_ids, tolerance=tolerance)
        return create_cut_set_eager(
            recordings=recordings, supervisions=supervisions, features=features,
            output_path=output_path, random_ids=random_ids, tolerance=tolerance)

    @staticmethod
    def from_dicts(data: Iterable[dict]) -> "CutSet":
        return CutSet.from_cuts(deserialize_cut(cut) for cut in data)

    @staticmethod
    def from_webdataset(path, **wds_kwargs) -> "CutSet":
        """Lazy CutSet over WebDataset tarball(s)."""
        from lhotse_tpu_torch.dataset.webdataset import LazyWebdatasetIterator

        return CutSet(cuts=LazyWebdatasetIterator(path, **wds_kwargs))

    @staticmethod
    def from_shar(
        fields: Optional[Dict[str, Sequence[Pathlike]]] = None, in_dir: Optional[Pathlike] = None,
        split_for_dataloading: bool = False, shuffle_shards: bool = False,
        stateful_shuffle: bool = True, seed: Union[int, str] = 42,
        cut_map_fns: Optional[Sequence[Callable[[Cut], Cut]]] = None,
        slice_length: Optional[int] = None, indexed: Optional[bool] = None, index_path=None,
        indexes_root: Optional[Pathlike] = None, lazy: bool = False) -> "CutSet":
        """
        Read cuts + data from Shar shards (one jsonl manifest + one tar per
        field per shard): streaming (LazySharIterator) or O(1) random-access
        (LazyIndexedSharIterator) when .idx files exist.
        """
        from lhotse_tpu_torch.shar.readers.indexed import LazyIndexedSharIterator
        from lhotse_tpu_torch.shar.readers.lazy import LazySharIterator

        use_indexed = indexed
        if (index_path is not None or indexes_root is not None) and indexed is False:
            raise ValueError(
                "index_path/indexes_root is set but indexed=False — contradictory arguments.")
        if use_indexed is None:
            use_indexed = (indexes_root is not None) or (
                LazyIndexedSharIterator.supports_configuration(
                    fields=fields, in_dir=in_dir, index_path=index_path))
        if use_indexed:
            if cut_map_fns:
                raise ValueError("'cut_map_fns' is not supported with indexed=True.")
            if slice_length is not None:
                raise ValueError("'slice_length' is not supported with indexed=True.")
            return CutSet(
                cuts=LazyIndexedSharIterator(
                    fields=fields, in_dir=in_dir, shuffle=shuffle_shards, seed=seed,
                    split_for_dataloading=split_for_dataloading, index_path=index_path,
                    indexes_root=indexes_root, lazy=lazy,
                )
            )
        return CutSet(
            cuts=LazySharIterator(
                fields=fields, in_dir=in_dir, split_for_dataloading=split_for_dataloading,
                shuffle_shards=shuffle_shards, stateful_shuffle=stateful_shuffle, seed=seed,
                cut_map_fns=cut_map_fns, slice_length=slice_length,
            )
        )

    def to_shar(
        self, output_dir: Pathlike, fields: Dict[str, str], shard_size: Optional[int] = 1000,
        shard_offset: int = 0, warn_unused_fields: bool = True, include_cuts: bool = True,
        num_jobs: int = 1, fault_tolerant: bool = False, verbose: bool = False,
        compress_jsonl: bool = True, create_index: bool = True) -> Dict[str, List[str]]:
        """
        Export cuts + selected data fields into Shar shards. ``fields`` maps
        field names to formats (e.g. {"recording": "wav", "features":
        "lilcom"}). Returns {field: [shard paths]}. The port shows no
        progress bar: ``verbose`` is accepted and ignored.
        """
        if not (isinstance(num_jobs, int) and num_jobs > 0):
            raise AssertionError(f"num_jobs must be a positive int, got {num_jobs}")
        shared = dict(
            output_dir=output_dir, shard_offset=shard_offset, fields=fields,
            warn_unused_fields=warn_unused_fields, fault_tolerant=fault_tolerant,
            compress_jsonl=compress_jsonl, create_index=create_index)
        if num_jobs == 1:
            return _export_to_shar_single(
                cuts=self, shard_size=shard_size, include_cuts=include_cuts, shard_suffix=None,
                verbose=verbose, **shared)

        # Pre-split to shard-sized jsonl chunks on disk, then one spawned
        # worker process per shard writes the tars.
        shards = self.split_lazy(
            output_dir=output_dir, chunk_size=shard_size, prefix="cuts", num_digits=6,
            start_idx=shard_offset)
        collected = defaultdict(list)
        import multiprocessing

        with ProcessPoolExecutor(num_jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
            jobs = [
                pool.submit( _export_to_shar_single, cuts=shard, shard_size=None, include_cuts=True, shard_suffix=f".{idx:06d}", verbose=False, preload=True, **shared, ) for idx,
                shard in enumerate(shards)]
            for job in as_completed(jobs):
                for field, paths in job.result().items():
                    collected[field].extend(paths)
        return {field: sorted(paths) for field, paths in collected.items()}

    def to_dicts(self) -> Iterable[dict]:
        return (cut.to_dict() for cut in self)

    def decompose(
        self, output_dir: Optional[Pathlike] = None, verbose: bool = False,
    ) -> Tuple[Optional[RecordingSet], Optional[SupervisionSet], Optional[FeatureSet]]:
        """Extract the unique (recordings, supervisions, features) manifests
        found in this CutSet (MixedCuts iterated over their tracks)."""
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)

        def sink(name):
            return output_dir / name if output_dir is not None else None

        seen_recordings, seen_sups = set(), set()
        with RecordingSet.open_writer(sink("recordings.jsonl.gz")) as rw, \
                SupervisionSet.open_writer(sink("supervisions.jsonl.gz")) as sw, \
                FeatureSet.open_writer(sink("features.jsonl.gz")) as fw:

            def harvest(cut: DataCut):
                if cut.has_recording and cut.recording_id not in seen_recordings:
                    seen_recordings.add(cut.recording_id)
                    rw.write(cut.recording)
                if cut.has_features:
                    fw.write(cut.features)
                for sup in cut.supervisions:
                    if sup.id not in seen_sups:
                        seen_sups.add(sup.id)
                        # Cut supervisions are cut-relative; undo the offset.
                        sw.write(sup.with_offset(cut.start))

            track = _progressbar(verbose, desc="Decomposing cuts")
            for cut in track(self):
                if isinstance(cut, DataCut):
                    harvest(cut)
                elif isinstance(cut, MixedCut):
                    for t in cut.tracks:
                        if isinstance(t.cut, DataCut):
                            harvest(t.cut)
        return rw.open_manifest(), sw.open_manifest(), fw.open_manifest()

    def describe(self, full: bool = False) -> None:
        """Print cut count / duration / speech statistics."""
        from lhotse_tpu_torch.cut.describe import CutSetStatistics

        stats = CutSetStatistics(full=full)
        stats.accumulate(self).describe()

    def split(
        self, num_splits: int, shuffle: bool = False, drop_last: bool = False) -> List["CutSet"]:
        """Split into ``num_splits`` pieces of (near-)equal size."""
        return [
            CutSet(subset)
            for subset in split_sequence(
                self, num_splits=num_splits, shuffle=shuffle, drop_last=drop_last,
            )
        ]

    def split_lazy(
        self, output_dir: Pathlike, chunk_size: int, prefix: str = "", num_digits: int = 8,
        start_idx: int = 0) -> List["CutSet"]:
        """Split into fixed-size chunks saved to disk as the input is consumed."""
        return split_manifest_lazy(
            self, output_dir=output_dir, chunk_size=chunk_size, prefix=prefix,
            num_digits=num_digits, start_idx=start_idx)

    def subset(
        self, *, supervision_ids: Optional[Iterable[str]] = None,
        cut_ids: Optional[Iterable[str]] = None, first: Optional[int] = None,
        last: Optional[int] = None) -> "CutSet":
        """Select a subset by first/last N, cut IDs (order-preserving), or
        supervision IDs (drops cuts without matches)."""
        if not exactly_one_not_null(supervision_ids, cut_ids, first, last):
            raise AssertionError("subset() can handle only one non-None arg.")
        if first is not None:
            if first <= 0:
                raise AssertionError("subset(first=...) must be positive")
            return CutSet(list(islice(self, first)))
        if last is not None:
            if last <= 0:
                raise AssertionError("subset(last=...) must be positive")
            total = len(self)
            if last > total:
                return self
            return CutSet(list(islice(self, total - last, total)))
        if supervision_ids is not None:
            wanted = set(supervision_ids)
            kept = [
                cut.filter_supervisions(lambda s: s.id in wanted)
                for cut in self
                if any(s.id in wanted for s in cut.supervisions)
            ]
            return CutSet(kept)
        requested = list(cut_ids)
        id_set = frozenset(requested)
        found = CutSet([cut for cut in self if cut.id in id_set])
        if len(found) < len(requested):
            logging.warning(
                f"In CutSet.subset(cut_ids=...): expected {len(requested)} cuts "
                f"but got {len(found)}."
            )
        return found.sort_like(requested)

    def map(
        self, transform_fn: Callable[[T], T], apply_fn: Optional[Callable[[T], bool]] = is_cut,
    ) -> "CutSet":
        ans = CutSet(LazyMapper(self.data, fn=transform_fn, apply_fn=apply_fn))
        if self.is_lazy:
            return ans
        eager = ans.to_eager()
        # Eager evaluation can validate immediately (reference parity:
        # test_cut_set.py::test_map_cut_set_rejects_noncut).
        assert all(is_cut(c) for c in eager), (
            "CutSet.map: transform_fn must return Cut objects."
        )
        return eager

    def filter_supervisions(self, predicate: Callable[[SupervisionSegment], bool]) -> "CutSet":
        """Keep only supervisions satisfying ``predicate`` (cuts without
        supervisions are preserved)."""
        return self.map(_CutOp("filter_supervisions", predicate))

    def merge_supervisions(
        self, merge_policy: str = "delimiter",
        custom_merge_fn: Optional[Callable[[str, Iterable[Any]], Any]] = None) -> "CutSet":
        """Merge each cut's supervisions into a single spanning segment."""
        return self.map(
            _CutOp("merge_supervisions", merge_policy=merge_policy, custom_merge_fn=custom_merge_fn)
        )

    def _one_to_many(self, op: "_SetOrCutOp", num_jobs: int) -> "CutSet":
        """Run a cut -> many-cuts method lazily (flattened) or fanned out over
        ``num_jobs`` worker processes."""
        if num_jobs == 1:
            return CutSet(LazyFlattener(LazyMapper(self.data, op)))
        from lhotse_tpu_torch.manipulation import split_parallelize_combine

        return split_parallelize_combine(num_jobs, self, op)

    def trim_to_supervisions(
        self, keep_overlapping: bool = True, min_duration: Optional[Seconds] = None,
        context_direction: str = "center", keep_all_channels: bool = False, num_jobs: int = 1,
    ) -> "CutSet":
        """One cut per supervision, with identical spans (optionally extended
        to min_duration with acoustic context)."""
        return self._one_to_many(
            _SetOrCutOp( "trim_to_supervisions", keep_overlapping=keep_overlapping, min_duration=min_duration, context_direction=context_direction, keep_all_channels=keep_all_channels, ),
            num_jobs)

    def trim_to_alignments(
        self, type: str, max_pause: Seconds = 0.0, max_segment_duration: Optional[Seconds] = None,
        delimiter: str = " ", keep_all_channels: bool = False, num_jobs: int = 1) -> "CutSet":
        """One cut per (merged) alignment item of the given type."""
        return self._one_to_many(
            _SetOrCutOp( "trim_to_alignments", type=type, max_pause=max_pause, max_segment_duration=max_segment_duration, delimiter=delimiter, keep_all_channels=keep_all_channels, ),
            num_jobs)

    def trim_to_unsupervised_segments(self) -> "CutSet":
        """Cuts made from segments with no supervisions (likely silence/noise)."""
        from lhotse_tpu_torch.cut.describe import find_segments_with_speaker_count

        cuts = []
        for cut in self:
            segments = find_segments_with_speaker_count(cut, min_speakers=0, max_speakers=0)
            for span in segments:
                cuts.append(cut.truncate(offset=span.start, duration=span.duration))
        return CutSet(cuts)

    def trim_to_supervision_groups(
        self, max_pause: Optional[Seconds] = None, num_jobs: int = 1) -> "CutSet":
        """One cut per supervision group (runs with gaps <= max_pause)."""
        if max_pause is None:
            max_pause = 0.0
        return self._one_to_many(
            _SetOrCutOp("trim_to_supervision_groups", max_pause=max_pause), num_jobs)

    def sort_by_recording_id(self, ascending: bool = True) -> "CutSet":
        """Sort alphabetically by recording_id (helps caching in save_audios)."""
        return CutSet(sorted(self, key=(lambda cut: cut.recording.id), reverse=not ascending))

    def sort_by_duration(self, ascending: bool = False) -> "CutSet":
        """Sort by cut duration (descending by default)."""
        return CutSet(sorted(self, key=(lambda cut: cut.duration), reverse=not ascending))

    def sort_like(self, other: Union["CutSet", Sequence[str]]) -> "CutSet":
        """Reorder to match the cut ID order of ``other``."""
        other_ids = list(other.ids if isinstance(other, CutSet) else other)
        assert set(self.ids) == set(
            other_ids
        ), "sort_like() expects both CutSets to have identical cut IDs."
        index_map: Dict[str, int] = {v: index for index, v in enumerate(other_ids)}
        ans: List[Cut] = [None] * len(other_ids)
        for cut in self:
            ans[index_map[cut.id]] = cut
        return CutSet(ans)

    def index_supervisions(
        self, index_mixed_tracks: bool = False, keep_ids: Optional[Set[str]] = None):
        """Two-level index {cut_id: interval index of supervisions}."""
        out = {}
        for cut in self:
            per_cut = cut.index_supervisions(
                index_mixed_tracks=index_mixed_tracks, keep_ids=keep_ids)
            out.update(per_cut)
        return out

    def combine_same_recording_channels(self) -> "CutSet":
        """Combine per-channel cuts of the same recording span into MultiCuts."""
        if self.mixed_cuts or self.multi_cuts:
            raise ValueError(
                "This operation is not applicable to CutSets containing "
                "MixedCuts or MultiCuts."
            )
        groups = defaultdict(list)
        for cut in self:
            groups[(cut.recording.id, cut.start, cut.end)].append(cut)
        return CutSet.from_cuts(MultiCut.from_mono(*cuts) for cuts in groups.values())

    def copy_data(self, output_dir: Pathlike, verbose: bool = True) -> "CutSet":
        """Copy every referenced data item (audio/features/custom arrays)
        into ``output_dir`` and return a manifest pointing at the copies.

        Each data cut's own window is stored under its ID: its audio as
        ``audio/{id[:3]}/{id}.wav``, its features in the default feature
        store (``features.lca`` or ``features/``) and each custom array
        ``k`` through a ``numpy_files`` writer in ``custom/{k}/``; the copy
        starts at 0 of its stored recording. A mixed cut's data tracks are
        stored the same way under ``{mixed id}-track{i}``. Custom
        recordings are not copied (``Cut.save_audio`` says which it keeps).
        The JAX package names each audio copy after its recording, so two
        cuts of one recording overwrite each other, and leaves mixed cuts'
        tracks and custom arrays pointing at the originals (ROADMAP C2)."""
        from lhotse_tpu_torch.array import Array, TemporalArray
        from lhotse_tpu_torch.features.io import NumpyFilesWriter

        output_dir = Path(output_dir)
        audio_dir = output_dir / "audio"
        audio_dir.mkdir(exist_ok=True, parents=True)
        feature_writer_type = default_features_storage_backend()
        if feature_writer_type is LilcomChunkyWriter:
            feature_storage = output_dir / "features.lca"
        else:
            feature_storage = output_dir / "features"
            feature_storage.mkdir(exist_ok=True, parents=True)
        custom_dir = output_dir / "custom"
        custom_dir.mkdir(exist_ok=True, parents=True)
        custom_writers = {}

        if verbose:
            from tqdm.auto import tqdm

            progbar = partial(tqdm, desc="Copying CutSet data")
        else:
            progbar = lambda x: x

        with CutSet.open_writer(
            output_dir / "cuts.jsonl.gz"
        ) as manifest_writer, feature_writer_type(feature_storage) as feature_writer:

            def custom_writer_for(key):
                if key not in custom_writers:
                    custom_writers[key] = NumpyFilesWriter(custom_dir / key)
                return custom_writers[key]

            def relocate(cut, name):
                custom = cut.custom or {}
                arrays = {k: v for k, v in custom.items() if isinstance(v, (Array, TemporalArray))}
                copy = fastcopy(
                    cut, features=None,
                    custom={k: v for k, v in custom.items() if k not in arrays} or None)
                if cut.has_recording:
                    (audio_dir / name[:3]).mkdir(exist_ok=True)
                    copy = copy.save_audio(audio_dir / name[:3] / f"{name}.wav")
                if cut.has_features:
                    feats = cut.features.load(start=cut.start, duration=cut.duration)
                    if feats.ndim == 3:  # load gives (C, T, F); a store holds (T, C, F)
                        feats = np.ascontiguousarray(feats.transpose(1, 0, 2))
                    copy.features = fastcopy(
                        cut.features, start=copy.start, duration=cut.duration,
                        num_frames=feats.shape[0], recording_id=copy.recording_id,
                        storage_type=feature_writer.name, storage_path=feature_writer.storage_path,
                        storage_key=feature_writer.write(name, feats))
                for k, v in arrays.items():
                    if isinstance(v, TemporalArray):
                        stored = custom_writer_for(k).store_array(
                            name, cut.load_custom(k), frame_shift=v.frame_shift,
                            temporal_dim=v.temporal_dim, start=copy.start)
                    else:
                        stored = custom_writer_for(k).store_array(name, v.load())
                    copy = copy.with_custom(k, stored)
                return copy

            for item in progbar(self):
                if isinstance(item, PaddingCut):
                    manifest_writer.write(item)
                elif isinstance(item, MixedCut):
                    tracks = [
                        fastcopy(t, cut=relocate(t.cut, f"{item.id}-track{i}"))
                        if isinstance(t.cut, DataCut) else t
                        for i, t in enumerate(item.tracks)]
                    manifest_writer.write(fastcopy(item, tracks=tracks))
                elif isinstance(item, DataCut):
                    manifest_writer.write(relocate(item, item.id))
                else:
                    raise RuntimeError(f"Unexpected manifest type: {type(item)}")

        return manifest_writer.open_manifest()

    def copy_feats(
        self, writer: FeaturesWriter, output_path: Optional[Pathlike] = None) -> "CutSet":
        """Re-store every feature matrix with ``writer``; returns an updated manifest."""
        with CutSet.open_writer(output_path) as manifest_writer:
            for item in self:
                out = item
                if item.has_features and not isinstance(item, PaddingCut):
                    if isinstance(item, MixedCut):
                        # New tracks: the JAX package rewrites the input's
                        # tracks in place (ROADMAP.md C2).
                        out = fastcopy(item, tracks=[
                            fastcopy(t, cut=fastcopy(
                                t.cut, features=t.cut.features.copy_feats(writer=writer)))
                            if isinstance(t.cut, DataCut) else t for t in item.tracks])
                    elif isinstance(item, DataCut):
                        out = fastcopy(item, features=item.features.copy_feats(writer=writer))
                manifest_writer.write(out)
        return manifest_writer.open_manifest()

    def modify_ids(self, transform_fn: Callable[[str], str]) -> "CutSet":
        """Transform every cut's ID with ``transform_fn``."""
        return self.map(_RenameCut(transform_fn))

    def pad(
        self, duration: Seconds = None, num_frames: int = None, num_samples: int = None,
        pad_feat_value: float = LOG_EPSILON, direction: str = "right", preserve_id: bool = False,
        pad_value_dict: Optional[Dict[str, Union[int, float]]] = None) -> "CutSet":
        """
        Pad every cut to duration/num_frames/num_samples (default: the longest
        cut, in frames if features exist, else samples, else seconds).
        """
        if all(arg is None for arg in (duration, num_frames, num_samples)):
            if all(c.has_features for c in self):
                num_frames = max(c.num_frames for c in self)
            elif all(c.has_recording for c in self):
                num_samples = max(c.num_samples for c in self)
            else:
                duration = max(cut.duration for cut in self)
        return self.map(
            _CutOp(
                "pad", duration=duration, num_frames=num_frames, num_samples=num_samples,
                pad_feat_value=pad_feat_value, direction=direction, preserve_id=preserve_id,
                pad_value_dict=pad_value_dict,
            )
        )

    def truncate(
        self, max_duration: Seconds, offset_type: str, keep_excessive_supervisions: bool = True,
        preserve_id: bool = False, rng: Optional[random.Random] = None) -> "CutSet":
        """Truncate cuts to at most ``max_duration``, from 'start'/'end'/'random'."""
        assert offset_type in ("start", "end", "random"), (f"Unknown offset type: '{offset_type}'")
        return self.map(
            partial(
                _truncate_single, max_duration=max_duration, offset_type=offset_type,
                keep_excessive_supervisions=keep_excessive_supervisions, preserve_id=preserve_id,
                rng=rng,
            )
        )

    def extend_by(
        self, duration: Seconds, direction: str = "both", preserve_id: bool = False,
        pad_silence: bool = True) -> "CutSet":
        """Extend cuts by ``duration`` with real recording context."""
        return self.map(
            _CutOp(
                "extend_by", duration=duration, direction=direction, preserve_id=preserve_id,
                pad_silence=pad_silence,
            )
        )

    def cut_into_windows(
        self, duration: Seconds, hop: Optional[Seconds] = None,
        keep_excessive_supervisions: bool = True, num_jobs: int = 1) -> "CutSet":
        """Traverse each cut in ``duration``-second windows every ``hop`` seconds."""
        if not hop:
            hop = duration
        return self._one_to_many(
            _SetOrCutOp( "cut_into_windows", duration=duration, hop=hop, keep_excessive_supervisions=keep_excessive_supervisions, ),
            num_jobs)

    def cut_into_windows_balanced(
        self, min_duration: Seconds, max_duration: Seconds, overlap: Seconds = 0.0,
        keep_excessive_supervisions: bool = True, num_jobs: int = 1) -> "CutSet":
        """Split cuts into windows sized within [min, max] to minimize padding."""
        return self._one_to_many(
            _SetOrCutOp( "cut_into_windows_balanced", min_duration=min_duration, max_duration=max_duration, overlap=overlap, keep_excessive_supervisions=keep_excessive_supervisions, ),
            num_jobs)

    def load_audio(
        self, collate: bool = False, limit: int = 1024,
    ) -> Union[List[np.ndarray], Tuple[np.ndarray, np.ndarray]]:
        """Read all cuts' audio into memory (mini-batch use)."""
        assert not self.is_lazy, "Cannot load audio of cuts in a lazy CutSet."
        assert len(self) < limit, (
            f"Cannot load audio of a CutSet with len={len(self)} (limit={limit}); "
            f"increase the limit if intended."
        )
        if collate:
            from lhotse_tpu_torch.dataset.collation import collate_audio

            audios, audio_lens = collate_audio(self)
            return np.asarray(audios), np.asarray(audio_lens)
        return [cut.load_audio() for cut in self]

    def sample(self, n_cuts: int = 1) -> Union[Cut, "CutSet"]:
        """Randomly sample ``n_cuts`` cuts (a single Cut when n_cuts == 1)."""
        assert n_cuts > 0
        cut_indices = random.sample(range(len(self)), min(n_cuts, len(self)))
        cuts = [self[idx] for idx in cut_indices]
        if n_cuts == 1:
            return cuts[0]
        return CutSet(cuts)

    def resample(
        self, sampling_rate: int, affix_id: bool = False, recording_field: Optional[str] = None,
    ) -> "CutSet":
        """Lazily resample all cuts (drops attached feature manifests)."""
        return self.map(
            _CutOp(
                "resample", sampling_rate=sampling_rate, affix_id=affix_id,
                recording_field=recording_field,
            )
        )

    def perturb_speed(self, factor: float, affix_id: bool = True) -> "CutSet":
        """Lazy speed perturbation over all cuts (supervisions follow)."""
        return self.map(_CutOp("perturb_speed", factor=factor, affix_id=affix_id))

    def perturb_tempo(self, factor: float, affix_id: bool = True) -> "CutSet":
        """Lazy tempo (pitch-preserving) perturbation over all cuts."""
        return self.map(_CutOp("perturb_tempo", factor=factor, affix_id=affix_id))

    def perturb_volume(self, factor: float, affix_id: bool = True) -> "CutSet":
        """Lazy volume perturbation over all cuts."""
        return self.map(_CutOp("perturb_volume", factor=factor, affix_id=affix_id))

    def narrowband(
        self, codec: str, restore_orig_sr: bool = True, affix_id: bool = True) -> "CutSet":
        """Lazy narrowband effect over all cuts."""
        return self.map(
            _CutOp("narrowband", codec=codec, restore_orig_sr=restore_orig_sr, affix_id=affix_id)
        )

    def normalize_loudness(
        self, target: float, mix_first: bool = True, affix_id: bool = True) -> "CutSet":
        """Lazy loudness normalization to ``target`` LUFS over all cuts."""
        return self.map(
            _CutOp("normalize_loudness", target=target, mix_first=mix_first, affix_id=affix_id)
        )

    def dereverb_wpe(self, affix_id: bool = True) -> "CutSet":
        """Lazy WPE dereverberation over all cuts."""
        return self.map(_CutOp("dereverb_wpe", affix_id=affix_id))

    def reverb_rir(
        self, rir_recordings: Optional["RecordingSet"] = None, normalize_output: bool = True,  # noqa: F821
        early_only: bool = False, affix_id: bool = True, rir_channels: List[int] = [0]) -> "CutSet":
        """Lazy reverberation with randomly chosen (or synthetic) RIRs."""
        rir_recordings = list(rir_recordings) if rir_recordings else None
        return self.map(
            _CutOp(
                "reverb_rir",
                rir_recording=random.choice(rir_recordings) if rir_recordings else None,
                normalize_output=normalize_output, early_only=early_only, affix_id=affix_id,
                rir_channels=rir_channels,
            )
        )

    def mix(
        self, cuts: "CutSet", duration: Optional[Seconds] = None, allow_padding: bool = False,
        snr: Optional[Union[Decibels, Sequence[Decibels]]] = 20, preserve_id: Optional[str] = None,
        mix_prob: float = 1.0, seed: Union[int, str, random.Random] = 42,
        random_mix_offset: bool = False, tag: Optional[str] = None) -> "CutSet":
        """Lazily mix randomly-sampled cuts from ``cuts`` into this CutSet
        (noise/music/babble augmentation)."""
        mixer = LazyCutMixer(
            cuts=self, mix_in_cuts=cuts, duration=duration, allow_padding=allow_padding, snr=snr,
            preserve_id=preserve_id, mix_prob=mix_prob, seed=seed,
            random_mix_offset=random_mix_offset, tag=tag)
        return CutSet(mixer)

    def drop_features(self) -> "CutSet":
        return self.map(_CutOp("drop_features"))

    def drop_recordings(self) -> "CutSet":
        return self.map(_CutOp("drop_recording"))

    def drop_supervisions(self) -> "CutSet":
        return self.map(_CutOp("drop_supervisions"))

    def drop_alignments(self) -> "CutSet":
        return self.map(_CutOp("drop_alignments"))

    def drop_in_memory_data(self) -> "CutSet":
        return self.map(_CutOp("drop_in_memory_data"))

    def compute_and_store_features(
        self, extractor: FeatureExtractor, storage_path: Pathlike, num_jobs: Optional[int] = None,
        augment_fn=None, storage_type: Optional[Type[FW]] = None,
        executor: Optional[Executor] = None, mix_eagerly: bool = True, progress_bar: bool = True,
    ) -> "CutSet":
        """
        Extract + store features for every cut, optionally fanning out over
        ``num_jobs`` spawned processes (work split via LazySlicer; per-job
        sub-storage merged with combine()). The port shows no progress bar:
        ``progress_bar`` is accepted and ignored.
        """
        num_jobs = ifnone(num_jobs, 1)
        storage_type = ifnone(storage_type, default_features_storage_backend())
        if num_jobs == 1 and executor is not None:
            logging.warning(
                "Executor argument was passed but num_jobs set to 1: ignoring "
                "the executor and using non-parallel execution."
            )
            executor = None

        if executor is None and num_jobs == 1:
            return self._extract_features_single_process(
                extractor, storage_type, storage_path, augment_fn, mix_eagerly)
        return self._extract_features_fanout(
            extractor, storage_type, storage_path, augment_fn, mix_eagerly, num_jobs, executor)

    def _extract_features_single_process(
        self, extractor, storage_type, storage_path, augment_fn, mix_eagerly) -> "CutSet":
        done = []
        with storage_type(storage_path) as storage:
            for cut in self:
                safe_extract = null_result_on_audio_loading_error(cut.compute_and_store_features)
                out = safe_extract(
                    extractor=extractor, storage=storage, augment_fn=augment_fn,
                    mix_eagerly=mix_eagerly)
                if out is not None:
                    done.append(out)
        return CutSet(done)

    def _extract_features_fanout(
        self, extractor, storage_type, storage_path, augment_fn, mix_eagerly, num_jobs,
        executor) -> "CutSet":
        from lhotse_tpu_torch.manipulation import combine as combine_manifests

        if "://" in str(storage_path):
            job_storage = [f"{storage_path}/feats-{i}" for i in range(num_jobs)]
        else:
            storage_path = Path(storage_path)
            storage_path.mkdir(parents=True, exist_ok=True)
            job_storage = [storage_path / f"feats-{i}" for i in range(num_jobs)]

        own_executor = executor is None
        if own_executor:
            import multiprocessing

            executor = ProcessPoolExecutor(
                num_jobs, mp_context=multiprocessing.get_context("spawn"))
        try:
            # Stripe the work: job i processes every num_jobs-th cut starting at i.
            futures = [
                executor.submit(
                    CutSet.compute_and_store_features,
                    CutSet(LazySlicer(self.data, k=i, n=num_jobs)), extractor=extractor,
                    storage_path=job_storage[i], augment_fn=augment_fn, storage_type=storage_type,
                    mix_eagerly=mix_eagerly, progress_bar=False,
                )
                for i in range(num_jobs)
            ]
            return combine_manifests([f.result() for f in futures])
        finally:
            if own_executor:
                executor.shutdown()

    def compute_and_store_features_batch(
        self, extractor: FeatureExtractor, storage_path: Pathlike,
        manifest_path: Optional[Pathlike] = None, batch_duration: Seconds = 600.0,
        num_workers: int = 4, collate: bool = True, augment_fn=None,
        storage_type: Optional[Type[FW]] = None, overwrite: bool = False) -> "CutSet":
        """
        Batched extraction for extractors with an accelerated
        ``extract_batch`` (the fbank kernel on the card): audio is read with
        a thread pool, extracted in one device call per batch of up to
        ``batch_duration`` seconds, and saved by a background writer thread.
        Resumes previously-interrupted runs when ``manifest_path`` exists.
        """
        from concurrent.futures import ThreadPoolExecutor

        from lhotse_tpu_torch.qa import validate_features
        from lhotse_tpu_torch.tracing import add_work, trace_span

        storage_type = ifnone(storage_type, default_features_storage_backend())
        frame_shift = extractor.frame_shift

        cuts_writer = CutSet.open_writer(manifest_path, overwrite=overwrite)

        def batches():
            """Greedy duration-based batching over cuts not yet processed."""
            batch, batch_dur = [], 0.0
            for cut in self:
                if cut.id in cuts_writer.ignore_ids:
                    continue
                if batch and batch_dur + cut.duration > batch_duration:
                    yield batch
                    batch, batch_dur = [], 0.0
                batch.append(cut)
                batch_dur += cut.duration
            if batch:
                yield batch

        def read_audio_safe(cut):
            return null_result_on_audio_loading_error(cut.load_audio)()

        def _save_worker(cuts: List[Cut], features: List[np.ndarray]) -> None:
            for cut, feat_mat in zip(cuts, features):
                if isinstance(cut, PaddingCut):
                    cuts_writer.write(
                        fastcopy(
                            cut, num_frames=feat_mat.shape[0], num_features=feat_mat.shape[1],
                            frame_shift=frame_shift,
                        )
                    )
                    continue
                storage_key = feats_writer.write(cut.id, np.asarray(feat_mat))
                feat_manifest = Features(
                    start=cut.start, duration=cut.duration, type=extractor.name,
                    num_frames=feat_mat.shape[0], num_features=feat_mat.shape[1],
                    frame_shift=frame_shift, sampling_rate=cut.sampling_rate, channels=cut.channel,
                    storage_type=feats_writer.name, storage_path=str(feats_writer.storage_path),
                    storage_key=storage_key)
                validate_features(feat_manifest, feats_data=np.asarray(feat_mat))
                if isinstance(cut, DataCut):
                    feat_manifest.recording_id = cut.recording_id
                    cut = fastcopy(cut, features=feat_manifest)
                elif isinstance(cut, MixedCut):
                    # A mixed cut flattens into a mono feature-only cut.
                    feat_manifest.recording_id = cut.id
                    cut = MonoCut(
                        id=cut.id, start=0, duration=cut.duration, channel=0,
                        supervisions=[
                            fastcopy(s, recording_id=cut.id, channel=0) for s in cut.supervisions],
                        features=feat_manifest, recording=None)
                cuts_writer.write(cut, flush=True)

        futures = []
        with cuts_writer, storage_type(
            storage_path, mode="w" if overwrite else "a"
        ) as feats_writer, ThreadPoolExecutor(
            max_workers=max(num_workers, 1)
        ) as read_pool, ThreadPoolExecutor(
            # One background writer so serialization order is deterministic.
            max_workers=1
        ) as save_pool:
            for batch in batches():
                with trace_span("CutSet.compute_and_store_features_batch"):
                    waves = list(read_pool.map(read_audio_safe, batch))
                    cuts = [c for c, w in zip(batch, waves) if w is not None]
                    waves = [w for w in waves if w is not None]
                    if len(cuts) == 0:
                        continue
                    assert all(c.sampling_rate == cuts[0].sampling_rate for c in cuts)
                    if augment_fn is not None:
                        waves = [augment_fn(w, c.sampling_rate) for c, w in zip(cuts, waves)]
                    flat = [w.reshape(-1) if w.ndim > 1 and w.shape[0] == 1 else w for w in waves]
                    add_work(sum(c.duration for c in cuts))
                    features = extractor.extract_batch(flat, sampling_rate=cuts[0].sampling_rate)
                if not isinstance(features, list):
                    features = [features[i] for i in range(len(cuts))] if features.ndim == 3 else [features]
                futures.append(save_pool.submit(_save_worker, cuts, features))
            for future in futures:
                future.result()

        return cuts_writer.open_manifest()

    def save_audios(
        self, storage_path: Pathlike, format: str = "wav", encoding: Optional[str] = None,
        num_jobs: Optional[int] = None, executor: Optional[Executor] = None, augment_fn=None,
        progress_bar: bool = True, shuffle_on_split: bool = True, **kwargs) -> "CutSet":
        """Store each cut's waveform to disk under
        ``{storage_path}/{id[:3]}/{id}.{format}``."""
        from lhotse_tpu_torch.manipulation import combine as combine_manifests

        num_jobs = ifnone(num_jobs, 1)
        if num_jobs == 1 and executor is not None:
            logging.warning("Executor argument was passed but num_jobs set to 1: ignoring it.")
            executor = None

        def target_file(cut: Cut) -> Path:
            # Bucket files into 3-char-prefix subdirs to keep dirs small.
            bucket = Path(storage_path) / cut.id[:3]
            bucket.mkdir(exist_ok=True, parents=True)
            return bucket / f"{cut.id}.{format}"

        if executor is None and num_jobs == 1:
            track = _progressbar(progress_bar, desc="Storing audio recordings")
            return CutSet(
                track(
                    cut.save_audio(
                        storage_path=target_file(cut), format=format, encoding=encoding,
                        augment_fn=augment_fn,
                    )
                    for cut in self
                )
            ).to_eager()

        if executor is None:
            import multiprocessing

            executor = ProcessPoolExecutor(
                max_workers=num_jobs, mp_context=multiprocessing.get_context("spawn"))
        futures = [
            executor.submit(
                CutSet.save_audios, piece, storage_path=storage_path, format=format,
                encoding=encoding, augment_fn=augment_fn, progress_bar=False,
            )
            for piece in self.split(num_jobs, shuffle=shuffle_on_split)
        ]
        track = _progressbar(
            progress_bar, desc="Storing audio recordings (chunks progress)", total=len(futures))
        return combine_manifests(track(f.result() for f in futures))

    def compute_global_feature_stats(
        self, storage_path: Optional[Pathlike] = None, max_cuts: Optional[int] = None,
        extractor: Optional[FeatureExtractor] = None) -> Dict[str, np.ndarray]:
        """Global per-bin mean/std via the streaming Chan–Golub–LeVeque update."""
        if extractor is not None:
            cuts = self
            if max_cuts is not None:
                cuts = islice(cuts, max_cuts)
            cuts = iter(cuts)
            first = next(cuts)
            stats = StatsAccumulator(feature_dim=extractor.feature_dim(first.sampling_rate))
            for cut in chain([first], cuts):
                arr = cut.compute_features(extractor)
                stats.update(arr)
            mvn = stats.get()
            if storage_path is not None:
                with open(storage_path, "wb") as f:
                    pickle.dump(mvn, f)
            return mvn

        have_features = [cut.has_features for cut in self]
        if not any(have_features):
            raise ValueError(
                "Could not find any features in this CutSet; did you forget to "
                "extract them?"
            )
        if not all(have_features):
            logging.warning(
                f"Computing global stats: only {sum(have_features)}/"
                f"{len(have_features)} cuts have features."
            )
        return compute_global_stats(
            feature_manifests=islice( (cut.features for cut in self if cut.has_features), max_cuts if max_cuts is not None else len(self), ),
            storage_path=storage_path)

    def with_features_path_prefix(self, path: Pathlike) -> "CutSet":
        return self.map(_CutOp("with_features_path_prefix", path))

    def with_recording_path_prefix(self, path: Pathlike) -> "CutSet":
        return self.map(_CutOp("with_recording_path_prefix", path))

    def fill_supervisions(self, add_empty: bool = True, shrink_ok: bool = False) -> "CutSet":
        """Make each cut's single supervision span its entire duration."""
        return self.map(_CutOp("fill_supervision", add_empty=add_empty, shrink_ok=shrink_ok))

    def map_supervisions(
        self, transform_fn: Callable[[SupervisionSegment], SupervisionSegment]) -> "CutSet":
        return self.map(_CutOp("map_supervisions", transform_fn))

    def transform_text(self, transform_fn: Callable[[str], str]) -> "CutSet":
        """Transform every supervision's text."""
        return self.map_supervisions(partial(_transform_text, transform_fn=transform_fn))

    @property
    def speakers(self) -> FrozenSet[str]:
        return frozenset(s.speaker for cut in self for s in cut.supervisions)

    def prefetch(self, buffer_size: int = 10) -> "CutSet":
        """
        Pre-fetch cuts in a background thread with a bounded buffer — enables
        concurrent read/process/write in ETL-style jobs.
        """
        return CutSet(_BackgroundPrefetchIterator(self.data, buffer_size=buffer_size))

    def to_huggingface_dataset(self):
        """Convert to a HuggingFace Dataset (requires `datasets`)."""
        from lhotse_tpu_torch.hf import export_cuts_to_hf

        return export_cuts_to_hf(self)

    @staticmethod
    def from_huggingface_dataset(*args, **kwargs) -> "CutSet":
        """Stream a HuggingFace dataset as cuts (requires `datasets`)."""
        from lhotse_tpu_torch.hf import LazyHFDatasetIterator

        return CutSet(LazyHFDatasetIterator(*args, **kwargs))

    @property
    def is_indexed(self) -> bool:
        return getattr(self.data, "is_indexed", False)

    @property
    def has_constant_time_access(self) -> bool:
        return getattr(self.data, "has_constant_time_access", False)

    def state_dict(self) -> dict:
        """Collect the checkpoint state of the underlying lazy iterator graph."""
        if not self.is_lazy:
            raise RuntimeError("state_dict() is only supported for lazy CutSets.")
        from lhotse_tpu_torch.checkpoint import collect_state_dict

        return collect_state_dict(self.data)

    def load_state_dict(self, state: dict) -> None:
        """Restore the checkpoint state into the underlying lazy iterator graph."""
        if not self.is_lazy:
            raise RuntimeError("load_state_dict() is only supported for lazy CutSets.")
        from lhotse_tpu_torch.checkpoint import restore_state_dict

        restore_state_dict(self.data, state)

    def __repr__(self) -> str:
        try:
            len_val = len(self)
        except Exception:
            len_val = "<unknown>"
        return f"CutSet(len={len_val}) [underlying data type: {type(self.data)}]"

    def __contains__(self, other: Union[str, Cut]) -> bool:
        if isinstance(other, str):
            return any(other == item.id for item in self)
        return any(other.id == item.id for item in self)

    def __getitem__(self, index_or_id: Union[int, str]) -> Cut:
        try:
            return self.cuts[index_or_id]
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

    def __len__(self) -> int:
        return len(self.cuts)

    def __iter__(self) -> Iterable[Cut]:
        yield from self.cuts


class _BackgroundPrefetchIterator:
    """Iterate the source in a daemon thread, buffering up to ``buffer_size``
    items in a queue."""

    def __init__(self, source: Iterable, buffer_size: int = 10):
        self.source = source
        self.buffer_size = buffer_size

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        _DONE = object()
        errors = []

        def worker():
            try:
                for item in self.source:
                    q.put(item)
            except BaseException as e:  # noqa
                errors.append(e)
            finally:
                q.put(_DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _DONE:
                break
            yield item
        if errors:
            raise errors[0]
        t.join()


def mix(
    reference_cut: Cut, mixed_in_cut: Cut, offset: Seconds = 0, allow_padding: bool = False,
    snr: Optional[Decibels] = None, preserve_id: Optional[str] = None, tag: Optional[str] = None,
) -> MixedCut:
    """
    Overlay two cuts: ``mixed_in_cut`` enters at ``offset`` seconds, scaled to
    ``snr`` dB below the reference.  The result is a MixedCut — summation only
    happens when it is loaded.
    """
    snr = _sanitize_mix_snr(reference_cut, mixed_in_cut, snr)
    _check_mixable(reference_cut, mixed_in_cut, offset, allow_padding)
    out_id = _pick_mixed_id(reference_cut, mixed_in_cut, preserve_id)
    if offset > reference_cut.duration:
        reference_cut = reference_cut.pad(duration=offset)
    tracks = _tracks_of_reference(reference_cut) + _tracks_of_mixed_in(
        mixed_in_cut, offset, snr, tag)
    return MixedCut(id=out_id, tracks=tracks)


def _sanitize_mix_snr(a: Cut, b: Cut, snr) -> Optional[Decibels]:
    if snr is not None and any(isinstance(c, PaddingCut) for c in (a, b)):
        warnings.warn(
            "You are mixing cuts to a padding cut with a specified SNR — "
            "setting snr to None to retain the original signal energies."
        )
        return None
    return snr


def _check_mixable(ref: Cut, other: Cut, offset: Seconds, allow_padding: bool) -> None:
    if (
        ref.num_features is not None
        and other.num_features is not None
        and ref.num_features != other.num_features
    ):
        raise AssertionError("Cannot mix cuts with different feature dimensions.")
    if offset > ref.duration and not allow_padding:
        raise AssertionError(
            f"Cannot mix cut '{other.id}' with offset {offset}, which is "
            f"greater than cut {ref.id}'s duration of {ref.duration}. "
            f"Set `allow_padding=True` to allow padding."
        )
    if ref.sampling_rate != other.sampling_rate:
        raise AssertionError(
            f"Cannot mix cuts with different sampling rates "
            f"({ref.sampling_rate} vs. {other.sampling_rate}). "
            f"Please resample the recordings first."
        )
    # Channel layouts must line up when MultiCuts are involved.
    if isinstance(ref, MultiCut) and isinstance(other, MultiCut):
        if ref.channel != other.channel:
            raise AssertionError("Cannot mix MultiCuts with different channel ids.")
    if isinstance(ref, MultiCut) or isinstance(other, MultiCut):
        mixed, multi = (ref, other) if isinstance(ref, MixedCut) else (other, ref)
        if isinstance(mixed, MixedCut) and not all(
            t.type != "MultiCut" or t.cut.channel == multi.channel
            for t in mixed.tracks
        ):
            raise AssertionError(
                "Cannot mix a MultiCut with a MixedCut containing MultiCuts "
                "with different channel ids."
            )


def _pick_mixed_id(ref: Cut, other: Cut, preserve_id: Optional[str]) -> str:
    if preserve_id is None:
        return str(uuid4())
    if preserve_id == "left":
        return ref.id
    if preserve_id == "right":
        return other.id
    raise ValueError(
        "Unexpected value for 'preserve_id' argument: "
        f"got '{preserve_id}', expected one of (None, 'left', 'right')."
    )


def _tracks_of_reference(ref: Cut) -> List[MixTrack]:
    # A clean MixedCut (no transforms/mutes) contributes its tracks directly;
    # anything else becomes a single opaque track.
    if (
        isinstance(ref, MixedCut)
        and not ifnone(ref.transforms, [])
        and not any(t.mute for t in ref.tracks)
    ):
        return _ensure_explicit_snr_reference(list(ref.tracks))
    if isinstance(ref, (DataCut, PaddingCut, MixedCut)):
        return [MixTrack(cut=ref, is_snr_reference=not isinstance(ref, PaddingCut))]
    raise ValueError(f"Unsupported type of cut in mix(): {type(ref)}")


def _tracks_of_mixed_in(other: Cut, offset, snr, tag) -> List[MixTrack]:
    if isinstance(other, (DataCut, PaddingCut)):
        return [MixTrack(cut=other, offset=offset, snr=snr, tag=tag)]
    if not isinstance(other, MixedCut):
        raise ValueError(f"Unsupported type of cut in mix(): {type(other)}")
    if ifnone(other.transforms, []) or any(t.mute for t in other.tracks):
        # Transforms/mutes must apply to the sub-mix as a whole: keep opaque.
        return [MixTrack(cut=other, offset=offset, snr=snr, tag=tag)]

    def combined_snr(track_snr):
        # No new SNR keeps the track's own; both present add up (SNRs are
        # relative to the first track of the mix).
        if snr is None:
            return track_snr
        if track_snr is None:
            return snr
        return track_snr + snr

    return [
        MixTrack(
            cut=t.cut, offset=round(t.offset + offset, ndigits=8), snr=combined_snr(t.snr),
            tag=t.tag if t.tag is not None else tag, is_snr_reference=False, mute=t.mute,
        )
        for t in other.tracks
    ]


def pad(
    cut: Cut, duration: Seconds = None, num_frames: int = None, num_samples: int = None,
    pad_feat_value: float = LOG_EPSILON, direction: str = "right", preserve_id: bool = False,
    pad_value_dict: Optional[Dict[str, Union[int, float]]] = None) -> Cut:
    """
    Grow a cut to a target duration / frame count / sample count (exactly one
    may be given) by appending a PaddingCut; returns the input unchanged when
    it already reaches the target.
    """
    from lhotse_tpu_torch.utils import DEFAULT_PADDING_VALUE

    if not exactly_one_not_null(duration, num_frames, num_samples):
        raise AssertionError(
            f"Expected only one of (duration, num_frames, num_samples) to be "
            f"set: got ({duration}, {num_frames}, {num_samples})"
        )
    _warn_about_unpadded_temporal_arrays(cut, pad_value_dict, DEFAULT_PADDING_VALUE)

    target = _pad_geometry(cut, duration, num_frames, num_samples)
    if target is None:
        return cut
    duration, total_num_frames, total_num_samples = target

    pad_span = round(duration - cut.duration, ndigits=8)
    video = None
    if cut.has_video:
        video = cut.video.copy_with(num_frames=compute_num_samples(pad_span, cut.video.fps))
    filler = PaddingCut(
        id=str(uuid4()), duration=pad_span, feat_value=pad_feat_value,
        num_features=cut.num_features,
        num_frames=(total_num_frames - cut.num_frames if cut.has_features else None),
        num_samples=( total_num_samples - cut.num_samples if cut.has_recording else None ),
        frame_shift=cut.frame_shift, sampling_rate=cut.sampling_rate, video=video,
        custom=pad_value_dict)

    if direction == "right":
        return cut.append(filler, preserve_id="left" if preserve_id else None)
    if direction == "left":
        return filler.append(cut, preserve_id="right" if preserve_id else None)
    if direction == "both":
        half = filler.truncate(duration=filler.duration / 2)
        return half.append(cut, preserve_id="right" if preserve_id else None).append(
            half, preserve_id="left" if preserve_id else None)
    raise ValueError(f"Unknown type of padding: {direction}")


def _warn_about_unpadded_temporal_arrays(cut, pad_value_dict, default_value) -> None:
    from lhotse_tpu_torch.array import TemporalArray

    custom = getattr(cut, "custom", None)
    if not isinstance(custom, dict):
        return
    arr_keys = [k for k, v in custom.items() if isinstance(v, TemporalArray)]
    missing = pad_value_dict is None or any(k not in pad_value_dict for k in arr_keys)
    if arr_keys and missing:
        warnings.warn(
            f"Cut being padded has custom TemporalArray attributes: {arr_keys}. "
            f"Expected a 'pad_value_dict' argument with padding values for "
            f"them; using the default (={default_value})."
        )


def _pad_geometry(cut, duration, num_frames, num_samples):
    """Resolve the pad target to (duration, frames, samples); None = no-op."""

    def frames_for(dur):
        if not cut.has_features:
            return None
        return compute_num_frames(
            duration=dur, frame_shift=cut.frame_shift, sampling_rate=cut.sampling_rate)

    def samples_for(dur):
        if not cut.has_recording:
            return None
        return compute_num_samples(duration=dur, sampling_rate=cut.sampling_rate)

    if duration is not None:
        if duration <= cut.duration:
            return None
        return duration, frames_for(duration), samples_for(duration)

    if num_frames is not None:
        if not cut.has_features:
            raise AssertionError(
                "Cannot pad a cut using num_frames when it is missing "
                "pre-computed features (run cut.compute_and_store_features(...) "
                "first)."
            )
        duration = num_frames * cut.frame_shift
        total_samples = samples_for(duration)
        already_there = (
            num_frames <= cut.num_frames
            and duration <= cut.duration
            and (total_samples is None or total_samples <= cut.num_samples)
        )
        if already_there:
            return None
        return duration, num_frames, total_samples

    if not cut.has_recording:
        raise AssertionError("Cannot pad a cut using num_samples when it is missing a Recording.")
    if num_samples <= cut.num_samples:
        return None
    duration = num_samples / cut.sampling_rate
    return duration, frames_for(duration), num_samples


def append(
    left_cut: Cut, right_cut: Cut, snr: Optional[Decibels] = None,
    preserve_id: Optional[str] = None) -> MixedCut:
    """Functional-style append of two cuts."""
    return left_cut.append(right_cut, snr=snr, preserve_id=preserve_id)


def mix_cuts(cuts: Iterable[Cut]) -> MixedCut:
    """Fold the cuts into one MixedCut by successive mixing."""
    return reduce(mix, cuts)


def append_cuts(cuts: Iterable[Cut]) -> Cut:
    """Fold the cuts into one MixedCut by successive appending."""
    return reduce(append, cuts)


def compute_supervisions_frame_mask(
    cut: Cut, frame_shift: Optional[Seconds] = None, use_alignment_if_exists: Optional[str] = None):
    """1-D 0/1 mask over frames covered by at least one supervision
    (reference: cut/set.py:3353)."""
    assert cut.has_features or frame_shift is not None, (
        "No features available; either pre-compute features or provide frame_shift."
    )
    if cut.has_features:
        frame_shift = cut.frame_shift
        num_frames = cut.num_frames
    else:
        num_frames = compute_num_frames(
            duration=cut.duration, frame_shift=frame_shift, sampling_rate=cut.sampling_rate)
    mask = np.zeros(num_frames, dtype=np.float32)
    for supervision in cut.supervisions:
        if (
            use_alignment_if_exists
            and supervision.alignment
            and use_alignment_if_exists in supervision.alignment
        ):
            for ali in supervision.alignment[use_alignment_if_exists]:
                st = round(ali.start / frame_shift) if ali.start > 0 else 0
                et = round(ali.end / frame_shift) if ali.end < cut.duration else num_frames
                mask[st:et] = 1.0
        else:
            st = round(supervision.start / frame_shift) if supervision.start > 0 else 0
            et = (
                round(supervision.end / frame_shift)
                if supervision.end < cut.duration
                else num_frames
            )
            mask[st:et] = 1.0
    return mask


def _cut_cls_and_channel_from_features(feats):
    mono = (feats.channels is None or isinstance(feats.channels, int) or len(feats.channels) == 1)
    if mono:
        return MonoCut, feats.channels if feats.channels is not None else 0
    return MultiCut, list(feats.channels)


def _cut_cls_and_channel_from_recording(recording):
    if recording.num_channels == 1:
        return MonoCut, recording.channel_ids[0]
    return MultiCut, recording.channel_ids


def _cut_from_features(idx, feats, recording, sup_source, random_ids, tolerance) -> Cut:
    cls, channel = _cut_cls_and_channel_from_features(feats)
    sups = []
    if sup_source is not None:
        sups = list(
            sup_source.find(
                recording_id=feats.recording_id, channel=channel, start_after=feats.start,
                end_before=feats.end, adjust_offset=True, tolerance=tolerance,
            )
        )
    return cls(
        id=str(uuid4()) if random_ids else f"{feats.recording_id}-{idx}", start=feats.start,
        duration=feats.duration, channel=channel, features=feats, recording=recording,
        supervisions=sups)


def _cut_from_recording(idx, recording, sup_source, random_ids) -> Cut:
    cls, channel = _cut_cls_and_channel_from_recording(recording)
    sups = []
    if sup_source is not None:
        sups = list(sup_source.find(recording_id=recording.id))
    return cls(
        id=str(uuid4()) if random_ids else f"{recording.id}-{idx}", start=0,
        duration=recording.duration, channel=channel, recording=recording, supervisions=sups)


def create_cut_set_eager(
    recordings: Optional[RecordingSet] = None, supervisions: Optional[SupervisionSet] = None,
    features: Optional[FeatureSet] = None, output_path: Optional[Pathlike] = None,
    random_ids: bool = False, tolerance: Seconds = 0.001) -> CutSet:
    """
    Materialize cuts from manifests: when features are given they set the cut
    boundaries (recordings optionally attached); otherwise each recording
    becomes one whole-recording cut.  Matching supervisions are attached with
    offsets made cut-relative.
    """
    if features is None and recordings is None:
        raise AssertionError("At least one of 'features' or 'recordings' has to be provided.")
    if supervisions is not None:
        supervisions = supervisions.to_eager()  # .find() needs random access
    if features is not None:
        if recordings is not None:
            recordings = recordings.to_eager()
        cuts = CutSet(
            [
                _cut_from_features(
                    idx, feats, recordings[feats.recording_id] if recordings is not None else None,
                    supervisions, random_ids, tolerance,
                )
                for idx, feats in enumerate(features)
            ]
        )
    else:
        cuts = CutSet(
            [
                _cut_from_recording(ridx, recording, supervisions, random_ids)
                for ridx, recording in enumerate(recordings)
            ]
        )
    if output_path is not None:
        cuts.to_file(output_path)
    return cuts


def create_cut_set_lazy(
    output_path: Pathlike, recordings: Optional[RecordingSet] = None,
    supervisions: Optional[SupervisionSet] = None, features: Optional[FeatureSet] = None,
    random_ids: bool = False, tolerance: Seconds = 0.001) -> CutSet:
    """
    Streaming variant of :func:`create_cut_set_eager`: writes cuts to
    ``output_path`` while consuming the inputs once.  Inputs must be sorted
    by recording id (supervisions are matched with a single forward scan).
    """
    if output_path is None:
        raise AssertionError(
            "You must provide the 'output_path' argument to create a CutSet lazily."
        )
    if features is None and recordings is None:
        raise AssertionError("At least one of 'features' or 'recordings' has to be provided.")
    for name, m in (
        ("recordings", recordings), ("supervisions", supervisions), ("features", features)):
        if m is not None and not m.is_lazy:
            logging.info(
                f"Manifest passed in argument '{name}' is not opened lazily; "
                f"open it with {type(m).__name__}.from_jsonl_lazy() to reduce "
                f"memory usage."
            )

    sup_stream = iter(supervisions) if supervisions is not None else None

    def sups_for(recording_id):
        nonlocal sup_stream
        if sup_stream is None:
            return None
        matched, sup_stream = _takewhile(sup_stream, lambda s: s.recording_id == recording_id)
        return SupervisionSet.from_segments(matched)

    with CutSet.open_writer(output_path) as writer:
        if features is not None:
            rec_stream = (iter(recordings) if recordings is not None else itertools.repeat(None))
            for idx, feats in enumerate(features):
                rec = next(rec_stream)
                if rec is not None and rec.id != feats.recording_id:
                    raise AssertionError(
                        f"Mismatched recording_id: Features.recording_id == "
                        f"{feats.recording_id} but Recording.id == '{rec.id}'"
                    )
                writer.write(
                    _cut_from_features(
                        idx, feats, rec, sups_for(feats.recording_id), random_ids, tolerance,
                    )
                )
        else:
            for ridx, recording in enumerate(recordings):
                writer.write(
                    _cut_from_recording(ridx, recording, sups_for(recording.id), random_ids)
                )
    if sup_stream is not None:
        # With correctly sorted inputs every supervision is consumed by the
        # forward scan; leftovers mean the sort contract was violated and
        # those supervisions were silently dropped from the cuts.
        leftovers = sum(1 for _ in sup_stream)
        if leftovers:
            warnings.warn(
                f"{leftovers} supervisions were not attached to any cut. The "
                "streaming manifest join requires all inputs sorted by "
                "recording id; sort the inputs first, or materialize them "
                "eagerly (CLI: pass --force-eager to 'cut simple').",
                stacklevel=2,
            )
    return CutSet.from_jsonl_lazy(output_path)


def _takewhile(
    iterable: Iterable[T], predicate: Callable[[T], bool]) -> Tuple[List[T], Iterable[T]]:
    """Like itertools.takewhile, but returns the remaining iterable including
    the first non-matching item."""
    collected = []
    try:
        while True:
            item = next(iterable)
            if predicate(item):
                collected.append(item)
            else:
                iterable = chain([item], iterable)
                break
    except StopIteration:
        pass
    return collected, iterable


def deserialize_cut(raw_cut: dict) -> Cut:
    """Dispatch on the 'type' field (reference: cut/set.py:3705)."""
    cut_type = raw_cut.pop("type")
    if cut_type == "MonoCut":
        return MonoCut.from_dict(raw_cut)
    if cut_type == "MultiCut":
        return MultiCut.from_dict(raw_cut)
    if cut_type == "PaddingCut":
        return PaddingCut.from_dict(raw_cut)
    if cut_type == "Cut":
        warnings.warn("Your manifest uses the legacy cut type name 'Cut'; interpreting as MonoCut.")
        return MonoCut.from_dict(raw_cut)
    if cut_type == "MixedCut":
        return MixedCut.from_dict(raw_cut)
    raise ValueError(f"Unexpected cut type during deserialization: '{cut_type}'")


class _CutOp:
    """Picklable ``cut -> cut.<method>(*args, **kwargs)``."""

    def __init__(self, method: str, *args, **kwargs):
        self.method = method
        self.args = args
        self.kwargs = kwargs

    def __call__(self, cut):
        return getattr(cut, self.method)(*self.args, **self.kwargs)


class _RenameCut:
    """Picklable ``cut -> cut.with_id(fn(cut.id))``."""

    def __init__(self, transform_fn):
        self.transform_fn = transform_fn

    def __call__(self, cut):
        return cut.with_id(self.transform_fn(cut.id))


class _SetOrCutOp(_CutOp):
    """Like _CutOp, but when handed a whole CutSet (the parallel fan-out path)
    it applies the method to the set and materializes the result."""

    def __call__(self, cuts_or_cut):
        result = getattr(cuts_or_cut, self.method)(*self.args, **self.kwargs)
        if isinstance(cuts_or_cut, CutSet):
            return result.to_eager()
        return result


def _transform_text(sup, transform_fn):
    return sup.transform_text(transform_fn)


def _truncate_single(
    cut: Cut, max_duration: Seconds, offset_type: str, keep_excessive_supervisions: bool = True,
    preserve_id: bool = False, rng: Optional[random.Random] = None) -> Cut:
    if cut.duration <= max_duration:
        return cut
    slack = cut.duration - max_duration
    if offset_type == "start":
        begin = 0.0
    elif offset_type == "end":
        begin = slack
    elif offset_type == "random":
        begin = (rng or random).uniform(0.0, slack)
    else:
        raise ValueError(f"Unknown 'offset_type' option: {offset_type}")
    return cut.truncate(
        offset=begin, duration=max_duration, preserve_id=preserve_id,
        keep_excessive_supervisions=keep_excessive_supervisions)


def _export_to_shar_single(
    cuts: CutSet, output_dir: Pathlike, shard_size: Optional[int], shard_offset: int,
    fields: Dict[str, str], warn_unused_fields: bool, include_cuts: bool,
    shard_suffix: Optional[str], verbose: bool, fault_tolerant: bool, preload: bool = False,
    compress_jsonl: bool = True, create_index: bool = True) -> Dict[str, List[str]]:
    from lhotse_tpu_torch.shar import SharWriter

    if preload:
        cuts = cuts.to_eager()
    shar = SharWriter(
        output_dir=output_dir, fields=fields, shard_size=shard_size, shard_offset=shard_offset,
        warn_unused_fields=warn_unused_fields, include_cuts=include_cuts, shard_suffix=shard_suffix,
        compress_jsonl=compress_jsonl, create_index=create_index)
    with shar as writer:
        for cut in cuts:
            try:
                writer.write(cut)
            except Exception as e:
                if not fault_tolerant:
                    raise
                logging.warning(f"Skipping: failed to load cut '{cut.id}'. Error message: {e}.")
    return writer.output_paths


class LazyCutMixer(IteratorNode):
    """
    Iterate over ``cuts`` while mixing randomly-sampled ``mix_in_cuts`` into
    them (noise/music/babble augmentation). With indexed noise + indexed
    sources, each output cut's mix is a pure function of
    (iteration seed, source graph token), enabling O(1) checkpoint restore.
    """

    def __init__(
        self, cuts: "CutSet", mix_in_cuts: "CutSet", duration: Optional[Seconds] = None,
        allow_padding: bool = False, snr: Optional[Union[Decibels, Sequence[Decibels]]] = 20,
        preserve_id: Optional[str] = None, mix_prob: float = 1.0,
        seed: Union[int, str, random.Random] = 42, random_mix_offset: bool = False,
        stateful: bool = True, tag: Optional[str] = None) -> None:
        if not 0.0 <= mix_prob <= 1.0:
            raise AssertionError(f"mix_prob must be in [0, 1], got {mix_prob}")
        if duration is not None and duration <= 0:
            raise AssertionError(f"duration must be positive, got {duration}")
        if isinstance(snr, (tuple, list)):
            if len(snr) != 2:
                raise AssertionError(
                    f"SNR range must be a list or tuple with exactly two values "
                    f"(got: {snr})"
                )
        elif not isinstance(snr, (type(None), int, float)):
            raise AssertionError(f"Unsupported snr value: {snr!r}")
        self.source = resolve_iterator_source(cuts)
        self._source_len_ref = cuts
        self.mix_in_cuts = mix_in_cuts
        self._mix_in_source = resolve_iterator_source(mix_in_cuts)
        self.duration, self.allow_padding, self.snr = duration, allow_padding, snr
        self.preserve_id, self.mix_prob, self.seed = preserve_id, mix_prob, seed
        self.random_mix_offset, self.stateful, self.tag = random_mix_offset, stateful, tag
        self.num_times_iterated = 0
        self._restored = False
        self._rng = self._rng_state = self._iteration_seed = self._mix_in_iter = None

    @property
    def is_checkpointable(self) -> bool:
        return (
            self.stateful
            and isinstance(self.source, IteratorNode)
            and self.source.is_checkpointable
            and self._noise_is_indexed()
        )

    is_indexed = property(
        lambda self: getattr(self.source, "is_indexed", False)
        and getattr(self._mix_in_source, "is_indexed", False)
    )

    @property
    def has_constant_time_access(self) -> bool:
        if isinstance(self.seed, random.Random):
            return False  # an opaque RNG cannot be replayed per item
        return supports_graph_restore(self.source) and self._noise_is_indexed()

    def __iter__(self):
        restored, self._restored = self._restored, False
        deterministic = self.has_constant_time_access

        iteration_seed = None
        if deterministic:
            # In the indexed regime the per-item RNG derives from
            # (iteration seed, source token) — no sequential RNG state at all.
            if restored and self._iteration_seed is not None:
                iteration_seed = self._iteration_seed
            else:
                iteration_seed = self._resolve_iteration_seed(self.num_times_iterated)
                if not restored:
                    self._iteration_seed = iteration_seed
            rng = None
        else:
            rng = self._sequential_rng(restored)
        self._rng = rng

        if self.stateful and not restored:
            self.num_times_iterated += 1
        if not self._noise_is_indexed():
            self._mix_in_iter = self._endless_noise(rng)

        for cut in self.source:
            if deterministic:
                token = get_graph_origin(cut)
                if token is None:
                    raise RuntimeError(
                        "LazyCutMixer requires '_graph_origin' on indexed source "
                        "items to support constant-time reconstruction."
                    )
                item_rng = self._make_item_rng(token, iteration_seed)
                yield attach_graph_origin(self._mix_one(cut, item_rng), token)
            else:
                yield self._mix_one(cut, rng)

    def _sequential_rng(self, restored: bool) -> random.Random:
        from lhotse_tpu_torch.dataset.dataloading import resolve_seed

        if restored and self._rng_state is not None:
            rng = random.Random()
            rng.setstate(self._rng_state)
            return rng
        if isinstance(self.seed, random.Random):
            return self.seed
        return random.Random(resolve_seed(self.seed) + self.num_times_iterated)

    def _endless_noise(self, rng):
        """An infinite shuffled stream over the mix-in cuts."""
        if self.mix_in_cuts.is_lazy:
            # A small lazy noise manifest would be re-opened and re-parsed on
            # every repeat cycle — and the shuffle buffer's pre-pull amplifies
            # that to hundreds of reopens before the first mixed cut is
            # emitted (e.g. a 4-cut jsonl pulled 2000 times = 500 file opens).
            # Materialize sources that fit the shuffle buffer once; stream
            # only genuinely large ones.
            head = list(itertools.islice(iter(self.mix_in_cuts), 2001))
            if len(head) <= 2000:
                small = CutSet.from_cuts(head)

                def cycle_small():
                    while True:
                        yield from small.shuffle(rng=rng)

                return cycle_small()
            return iter(self.mix_in_cuts.repeat().shuffle(rng=rng, buffer_size=2000))

        def cycle():
            while True:
                yield from self.mix_in_cuts.shuffle(rng=rng)

        return cycle()

    def _noise_is_indexed(self) -> bool:
        return getattr(self._mix_in_source, "is_indexed", False) and supports_graph_restore(
            self._mix_in_source, require_length=True)

    def _next_mix_in_cut(self, rng: random.Random) -> Cut:
        if self._noise_is_indexed():
            idx = rng.randrange(len(self._mix_in_source))
            return self._mix_in_source[idx]
        return next(self._mix_in_iter)

    def _resolve_iteration_seed(self, iteration_idx: int) -> int:
        from lhotse_tpu_torch.dataset.dataloading import resolve_seed

        if isinstance(self.seed, random.Random):
            raise RuntimeError(
                "LazyCutMixer with seed=random.Random does not support "
                "constant-time restore."
            )
        return resolve_seed(self.seed) + iteration_idx

    @staticmethod
    def _combine_seed(iteration_seed: int, source_token: Any) -> int:
        token_bytes = pickle.dumps(normalize_graph_token(source_token), protocol=4)
        token_seed = int.from_bytes(
            hashlib.blake2b(token_bytes, digest_size=8).digest(), byteorder="little")
        return ((iteration_seed * 0x9E3779B97F4A7C15) + token_seed) & 0xFFFFFFFFFFFFFFFF

    def _make_item_rng(self, source_token: Any, iteration_seed: int) -> random.Random:
        return random.Random(self._combine_seed(iteration_seed, source_token))

    def _mix_one(self, cut: Cut, rng: random.Random) -> Cut:
        if not is_cut(cut) or rng.uniform(0.0, 1.0) > self.mix_prob:
            return cut
        snr = rng.uniform(*self.snr) if isinstance(self.snr, (list, tuple)) else self.snr
        # Target 50 ms short of the cut so the last noise chunk never collapses
        # to 0 feature frames.
        goal = round(self.duration if self.duration is not None else cut.duration - 0.05, ndigits=8)
        covered = 0.0
        mixed = cut
        while True:
            chunk = self._maybe_truncate_cut(self._next_mix_in_cut(rng), goal - covered, rng)
            mixed = mixed.mix(
                other=chunk, snr=snr, offset_other_by=covered if covered > 0 else 0,
                allow_padding=self.allow_padding if covered > 0 else False,
                preserve_id=self.preserve_id, tag=self.tag)
            covered = round(covered + chunk.duration, ndigits=8)
            if covered >= goal - 0.05:
                break
        return mixed.truncate(
            duration=self.duration if self.duration is not None else cut.duration,
            preserve_id=self.preserve_id is not None)

    def __getitem__(self, idx: Any) -> Cut:
        if not self.has_constant_time_access:
            raise TypeError(
                "LazyCutMixer only supports __getitem__ when both the source and "
                "mix-in cuts provide constant-time indexed access."
            )
        token = normalize_graph_token(idx)
        seed0 = self._iteration_seed
        if seed0 is None:
            seed0 = self._resolve_iteration_seed(0)
        remixed = self._mix_one(self.source[token], self._make_item_rng(token, seed0))
        return attach_graph_origin(remixed, token)

    def state_dict(self) -> dict:
        if not self.is_checkpointable:
            raise NotImplementedError("LazyCutMixer checkpointing requires indexed mix_in_cuts.")
        from lhotse_tpu_torch.checkpoint import _rng_state_to_json

        rng_state = self._rng.getstate() if self._rng is not None else self._rng_state
        snap = {
            "num_times_iterated": self.num_times_iterated,
            "rng_state": _rng_state_to_json(rng_state) if rng_state is not None else None,
            "iteration_seed": self._iteration_seed}
        source_state = _snapshot_child(self.source)
        if source_state is not None:
            snap["source"] = source_state
        return snap

    def load_state_dict(self, state: dict) -> None:
        if not self.is_checkpointable:
            raise NotImplementedError("LazyCutMixer checkpointing requires indexed mix_in_cuts.")
        from lhotse_tpu_torch.checkpoint import _rng_state_from_json

        self.num_times_iterated = state["num_times_iterated"]
        saved_rng = state.get("rng_state")
        self._rng_state = None if saved_rng is None else _rng_state_from_json(saved_rng)
        self._iteration_seed = state.get("iteration_seed")
        _restore_child(self.source, state.get("source"))
        self._restored = True

    def _maybe_truncate_cut(self, cut: Cut, target_duration: Seconds, rng: random.Random) -> Cut:
        if not self.random_mix_offset or cut.duration <= target_duration:
            return cut
        slack = cut.duration - target_duration
        return cut.truncate(offset=rng.uniform(0, slack), duration=target_duration)

    def __len__(self) -> int:
        return len(self._source_len_ref)

    # The live noise stream is a generator — transient iteration state that
    # must not (and cannot) cross process boundaries.
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_mix_in_iter"] = None
        if is_dill_enabled():
            import dill

            return dill.dumps(state)
        return state
