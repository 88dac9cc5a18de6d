"""
CutSet: the eager or lazy collection of cuts (copied from
``lhotse_tpu/cut/set.py``), with the part of its algebra the data path
uses: construction from cuts, manifests and lazy JSONL, ``filter``,
``map``, ``shuffle``, ``repeat``, ``subset``, ``split``, ``modify_ids``,
``sort_by_duration``, ``+``, checkpointing of the lazy graph, feature
extraction and storage (``compute_and_store_features``, single-process or
fanned out over spawned processes, and ``compute_and_store_features_batch``),
``drop_features`` and the supervisions' frame mask.

Left out: mixing, padding, windowing and trimming, Shar and the other
constructors.
"""
from __future__ import annotations

import logging
import warnings
from concurrent.futures import Executor, ProcessPoolExecutor
from itertools import islice
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Type, TypeVar, Union

import numpy as np

from lhotse_tpu_torch.audio import null_result_on_audio_loading_error
from lhotse_tpu_torch.cut.base import Cut
from lhotse_tpu_torch.cut.data import DataCut
from lhotse_tpu_torch.cut.mono import MonoCut
from lhotse_tpu_torch.features.base import FeatureExtractor, Features
from lhotse_tpu_torch.features.io import FeaturesWriter, default_features_storage_backend
from lhotse_tpu_torch.lazy import AlgorithmMixin, LazyMapper, LazySlicer
from lhotse_tpu_torch.serialization import Serializable
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import (
    Pathlike, Seconds, compute_num_frames, exactly_one_not_null, fastcopy, ifnone, not_ported,
    split_sequence)

T = TypeVar("T")
FW = TypeVar("FW", bound=FeaturesWriter)


def is_cut(example) -> bool:
    # MultiCut, MixedCut and PaddingCut are not ported: MonoCut is every cut here.
    return isinstance(example, MonoCut)


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
    ids = property(lambda self: (c.id for c in self.cuts))

    @staticmethod
    def from_cuts(cuts: Iterable[Cut]) -> "CutSet":
        return CutSet(list(cuts))

    from_items = from_cuts

    @staticmethod
    def from_dicts(data: Iterable[dict]) -> "CutSet":
        return CutSet.from_cuts(deserialize_cut(cut) for cut in data)

    def to_dicts(self) -> Iterable[dict]:
        return (cut.to_dict() for cut in self)

    def split(
        self, num_splits: int, shuffle: bool = False, drop_last: bool = False) -> List["CutSet"]:
        """Split into ``num_splits`` pieces of (near-)equal size."""
        return [
            CutSet(subset)
            for subset in split_sequence(
                self, num_splits=num_splits, shuffle=shuffle, drop_last=drop_last,
            )
        ]

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

    def modify_ids(self, transform_fn: Callable[[str], str]) -> "CutSet":
        """Transform every cut's ID with ``transform_fn``."""
        return self.map(_RenameCut(transform_fn))

    def drop_features(self) -> "CutSet":
        return self.map(_CutOp("drop_features"))

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
                if not isinstance(cut, DataCut):
                    raise not_ported(
                        f"compute_and_store_features_batch for {type(cut).__name__} "
                        "(PaddingCut, MixedCut)")
                storage_key = feats_writer.write(cut.id, np.asarray(feat_mat))
                feat_manifest = Features(
                    start=cut.start, duration=cut.duration, type=extractor.name,
                    num_frames=feat_mat.shape[0], num_features=feat_mat.shape[1],
                    frame_shift=frame_shift, sampling_rate=cut.sampling_rate, channels=cut.channel,
                    storage_type=feats_writer.name, storage_path=str(feats_writer.storage_path),
                    storage_key=storage_key)
                validate_features(feat_manifest, feats_data=np.asarray(feat_mat))
                feat_manifest.recording_id = cut.recording_id
                cuts_writer.write(fastcopy(cut, features=feat_manifest), flush=True)

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


def deserialize_cut(raw_cut: dict) -> Cut:
    """Dispatch on the 'type' field (reference: cut/set.py:3705)."""
    cut_type = raw_cut.pop("type")
    if cut_type == "MonoCut":
        return MonoCut.from_dict(raw_cut)
    if cut_type in ("MultiCut", "PaddingCut", "MixedCut"):
        raise not_ported(cut_type)
    if cut_type == "Cut":
        warnings.warn("Your manifest uses the legacy cut type name 'Cut'; interpreting as MonoCut.")
        return MonoCut.from_dict(raw_cut)
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
