"""
DynamicCutSampler: streaming constraint batching over one or more CutSets
(copied from ``lhotse_tpu/dataset/sampling/dynamic.py``), with
``DurationBatcher``, ``Filter`` and ``check_constraint``, which
``DynamicBucketingSampler`` builds on. It takes lazy inputs, joint
iteration of several CutSets (pairs/triplets), a buffered streaming shuffle
per epoch, and the two checkpoint-restore paths (seek, replay) of
:mod:`lhotse_tpu_torch.dataset.sampling.checkpoint_backends`.
"""
import random
import warnings
from collections import deque
from typing import (Any, Callable, Dict, Generator, Iterable, List, Optional, Tuple, Union)

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.dataset.dataloading import resolve_seed
from lhotse_tpu_torch.dataset.sampling.base import (
    CutSampler, SamplingConstraint, SamplingDiagnostics, TimeConstraint, capture_sources_state,
    restore_sources_state)
from lhotse_tpu_torch.dataset.sampling.checkpoint_backends import plan_resume
from lhotse_tpu_torch.lazy import LazyShuffler, resolve_iterator_source
from lhotse_tpu_torch.utils import Seconds, ifnone


class DynamicCutSampler(CutSampler):
    """
    Streaming sampler with no stratification: zips one or more (lazy) CutSets,
    filters, and batches by a :class:`SamplingConstraint`. With multiple input
    CutSets it yields tuples of CutSets (for paired-utterance tasks); the
    constraint is measured on the first CutSet only.

    Single-CutSet use::

        >>> sampler = DynamicCutSampler(cuts, max_duration=100)
        >>> for batch in sampler: assert isinstance(batch, CutSet)

    Paired use (cut IDs must line up; checked unless consistent_ids=False)::

        >>> sampler = DynamicCutSampler(src_cuts, tgt_cuts, max_duration=100)
    """

    def __init__(
        self, *cuts: Iterable, max_duration: Optional[Seconds] = None,
        max_cuts: Optional[int] = None, constraint: Optional[SamplingConstraint] = None,
        shuffle: bool = False, drop_last: bool = False, consistent_ids: bool = True,
        shuffle_buffer_size: int = 20000, quadratic_duration: Optional[Seconds] = None,
        world_size: Optional[int] = None, rank: Optional[int] = None, seed: Union[int, str] = 0,
        strict=None,
    ) -> None:
        super().__init__(drop_last=drop_last, world_size=world_size, rank=rank, seed=seed)
        if strict is not None:
            warnings.warn(
                "All samplers act as if 'strict=True'; the 'strict' argument is "
                "accepted for backward compatibility only and will be removed.",
                DeprecationWarning)
        eager_inputs = [cs for cs in cuts if isinstance(cs, CutSet) and not cs.is_lazy]
        if eager_inputs:
            warnings.warn(
                "You are using DynamicCutSampler with an eagerly read CutSet. "
                "You won't see any memory/speed benefits with that setup. "
                "Use e.g. 'CutSet.from_jsonl_lazy' to read the CutSet lazily."
            )
        self.cuts, self.constraint, self.shuffle = cuts, constraint, shuffle
        self.max_duration, self.max_cuts = max_duration, max_cuts
        self.consistent_ids = consistent_ids
        self.shuffle_buffer_size = shuffle_buffer_size
        self.quadratic_duration = quadratic_duration
        self._active_cuts = None

    _CONFIG_KEYS = (
        "max_duration", "max_cuts", "consistent_ids", "shuffle_buffer_size", "quadratic_duration")

    def state_dict(self) -> Dict[str, Any]:
        # Custom constraint objects are reconstructed from config, not stored;
        # the iteration state (epoch/diagnostics/source-graph) drives resume.
        sd = super().state_dict()
        for key in self._CONFIG_KEYS:
            sd[key] = getattr(self, key)
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for key in self._CONFIG_KEYS:
            setattr(self, key, sd.pop(key))
        super().load_state_dict(sd)
        # Defer the restore work to __iter__ so the sampler stays picklable
        # for multiprocess dataloading.
        self._needs_fast_forward = True

    def _fast_forward(self):
        current_epoch = self.diagnostics.current_epoch
        num_batches_to_iter = self.diagnostics.current_epoch_stats.total_batches
        self.set_epoch(current_epoch)
        plan_resume(self, "dynamic", epoch=current_epoch, steps_done=num_batches_to_iter).run()

    def _initialize_replay_iterator(self) -> None:
        self._cuts_state, self._active_cuts = None, None
        self._just_restored_state = False
        self._initialize_epoch_iterator(rebuild_sources=True)

    def _replay_step(self) -> None:
        next(self)

    def _wrap_shuffled(self, src, rng_seed: int):
        """One input stream -> buffered streaming shuffle for this epoch."""
        mixed = LazyShuffler(
            resolve_iterator_source(src), buffer_size=self.shuffle_buffer_size,
            rng=random.Random(rng_seed))
        return CutSet(mixed) if isinstance(src, CutSet) else mixed

    def _make_epoch_sources(self):
        if not self.shuffle:
            return list(self.cuts)
        rng_seed = resolve_seed(self.seed) + self.epoch
        return [self._wrap_shuffled(src, rng_seed) for src in self.cuts]

    def _initialize_epoch_iterator(self, *, rebuild_sources: bool) -> None:
        if rebuild_sources or self._active_cuts is None:
            self._active_cuts = self._make_epoch_sources()
        streams = tuple(iter(resolve_iterator_source(cs)) for cs in self._active_cuts)
        surviving = Filter(
            iterator=zip(*streams), predicate=lambda tpl: all(map(self._filter_fn, tpl)),
            diagnostics=self.diagnostics)
        self.cuts_iter = iter(
            DurationBatcher(
                surviving,
                max_duration=self.max_duration,
                max_cuts=self.max_cuts,
                constraint=self.constraint,
                drop_last=self.drop_last,
                quadratic_duration=self.quadratic_duration,
                diagnostics=self.diagnostics,
            )
        )

    def _capture_cuts_state(self) -> Optional[list]:
        return capture_sources_state(ifnone(self._active_cuts, self.cuts))

    def _restore_cuts_state(self, cuts_state: list) -> None:
        self._active_cuts = self._make_epoch_sources()
        restore_sources_state(self._active_cuts, cuts_state)

    def __iter__(self) -> "DynamicCutSampler":
        if getattr(self, "_needs_fast_forward", False):
            self._needs_fast_forward = False
            self._fast_forward()
            return self
        if self._just_restored_state:
            return self
        # Re-iterating the current epoch resets its stats (otherwise restore
        # would replay more steps than the epoch contains) — unless a restore
        # path asked to keep them for exactly one re-iteration.
        if not getattr(self, "_skip_diagnostics_reset_once", False):
            self.diagnostics.reset_current_epoch()
        self._skip_diagnostics_reset_once = False
        self._initialize_epoch_iterator(rebuild_sources=True)
        return self

    def _next_batch(self) -> Union[CutSet, Tuple[CutSet]]:
        batch = next(self.cuts_iter)
        if self.consistent_ids and isinstance(batch, tuple):
            for group in zip(*batch):
                ids = {c.id for c in group}
                assert len(ids) == 1, (
                    f"The input CutSets are not sorted by cut ID in the same way. "
                    f"We sampled the following mismatched cut IDs: "
                    f"{', '.join(c.id for c in group)}. If this is expected, pass "
                    f"'consistent_ids=False'."
                )
        return batch

    # Streaming samplers cannot see ahead: progress totals are unknown.
    remaining_duration = property(lambda self: None)
    remaining_cuts = property(lambda self: None)
    num_cuts = property(lambda self: None)


def _regroup(items: List[Union[Cut, Tuple[Cut]]]) -> Union[CutSet, Tuple[CutSet]]:
    """A list of cuts (or aligned cut-tuples) -> CutSet (or tuple thereof)."""
    head = items[0]
    if not isinstance(head, tuple):
        return CutSet.from_cuts(items)
    if len(head) == 1:
        return CutSet.from_cuts(tpl[0] for tpl in items)
    return tuple(CutSet.from_cuts(column) for column in zip(*items))


class DurationBatcher:
    """Greedy constraint-batching over a cut (or cut-tuple) iterator."""

    def __init__(
        self, datapipe: Iterable[Union[Cut, Tuple[Cut]]], max_duration: Seconds = None,
        max_cuts: Optional[int] = None, constraint: Optional[SamplingConstraint] = None,
        drop_last: bool = False, quadratic_duration: Optional[Seconds] = None,
        diagnostics: Optional[SamplingDiagnostics] = None) -> None:
        self.datapipe, self.drop_last = datapipe, drop_last
        self.reuse_cuts_buffer = deque()
        self.diagnostics = ifnone(diagnostics, SamplingDiagnostics())
        check_constraint(constraint, max_duration, max_cuts)
        self.constraint = (
            constraint
            if constraint is not None
            else TimeConstraint(
                max_duration=max_duration,
                max_cuts=max_cuts,
                quadratic_duration=quadratic_duration,
            )
        )

    def __iter__(self) -> Generator[Union[CutSet, Tuple[CutSet]], None, None]:
        self.cuts_iter = iter(self.datapipe)
        try:
            while True:
                yield self._collect_batch()
        except StopIteration:
            pass
        self.cuts_iter = None

    def _end_of_stream(self, group: list):
        if group and (not self.drop_last or self.constraint.close_to_exceeding()):
            return _regroup(group)
        try:
            self.diagnostics.discard(group)
        except AttributeError:  # group may hold tuples
            self.diagnostics.discard(group[0])
        raise StopIteration()

    def _collect_batch(self) -> Union[CutSet, Tuple[CutSet]]:
        self.constraint.reset()
        group = []
        while True:
            try:
                item = next(self.cuts_iter)
            except StopIteration:
                return self._end_of_stream(group)

            group.append(item)
            self.constraint.add(item[0] if isinstance(item, tuple) else item)
            if not self.constraint.close_to_exceeding():
                continue
            if len(group) == 1 and self.constraint.exceeded():
                warnings.warn(
                    "We have exceeded the max_duration constraint during "
                    "sampling but have only 1 cut. This is likely because "
                    "max_duration was set to a very low value ~10s, or "
                    "you're using a CutSet with very long cuts (e.g. 100s "
                    "of seconds long)."
                )
            return _regroup(group)


class Filter(Iterable):
    """Lazy filter that also records discarded items in the diagnostics."""

    def __init__(
        self, iterator: Iterable, predicate: Callable[[Cut], bool],
        diagnostics: Optional[SamplingDiagnostics] = None) -> None:
        self.iterator = iterator
        self.predicate = predicate
        self.diagnostics = ifnone(diagnostics, SamplingDiagnostics())
        assert callable(self.predicate), (
            f"Filter: 'predicate' arg must be callable (got {predicate})."
        )

    def _note_discarded(self, item) -> None:
        for c in item if isinstance(item, tuple) else (item,):
            self.diagnostics.discard_single(c)

    def __iter__(self) -> Iterable:
        for item in self.iterator:
            if self.predicate(item):
                yield item
            else:
                self._note_discarded(item)


def check_constraint(constraint, max_duration, max_cuts) -> None:
    if constraint is not None:
        assert max_duration is None and max_cuts is None, (
            "Cannot specify both constraint= and max_duration=/max_cuts="
        )
    else:
        assert max_duration is not None or max_cuts is not None, (
            "At least one of max_duration= or max_cuts= has to be defined "
            "(or provide constraint=)."
        )
