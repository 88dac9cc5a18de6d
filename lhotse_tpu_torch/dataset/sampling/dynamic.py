"""
Greedy constraint batching over a cut stream (copied from
``lhotse_tpu/dataset/sampling/dynamic.py``): ``DurationBatcher``,
``Filter`` and ``check_constraint``, which ``DynamicBucketingSampler``
builds on. ``DynamicCutSampler`` is not ported.
"""
import warnings
from collections import deque
from typing import Callable, Generator, Iterable, List, Optional, Tuple, Union

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.dataset.sampling.base import (
    SamplingConstraint, SamplingDiagnostics, TimeConstraint)
from lhotse_tpu_torch.utils import Seconds, ifnone


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
