"""
ZipSampler: lockstep iteration over several samplers (copied from
``lhotse_tpu/dataset/sampling/zip.py``). Yields merged CutSets (or tuples)
with one batch from each sub-sampler per step; stops when any sub-sampler
is depleted.
"""
from functools import reduce
from operator import add
from typing import Any, Callable, Dict, Optional, Tuple, Union

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.dataset.sampling.base import CutSampler, SamplingDiagnostics


def _merge_batches(batches) -> Union[CutSet, Tuple[CutSet, ...]]:
    """
    Flatten one batch per sub-sampler into a single CutSet. Pair-samplers
    yield tuples of CutSets; those are merged element-wise into a tuple.
    """
    if not batches:
        return CutSet()
    if isinstance(batches[-1], CutSet):
        return CutSet.from_cuts(cut for batch in batches for cut in batch)
    arity = len(batches[-1])
    return tuple(
        CutSet.from_cuts(cut for batch in batches for cut in batch[pos])
        for pos in range(arity)
    )


class ZipSampler(CutSampler):
    """
    Concatenates the mini-batches of several samplers into one CutSet (or a
    tuple of CutSets with ``merge_batches=False``) — useful to guarantee each
    batch holds a fixed proportion of data from different sources::

        >>> sampler = ZipSampler(
        ...     SimpleCutSampler(cuts_corpusA, max_duration=250, shuffle=True),
        ...     SimpleCutSampler(cuts_corpusB, max_duration=100, shuffle=True),
        ... )
    """

    def __init__(self, *samplers: CutSampler, merge_batches: bool = True) -> None:
        super().__init__(rank=0, world_size=1)
        self.samplers = samplers
        self.merge_batches = merge_batches

    def _min_over(self, attr: str) -> Optional[Union[int, float]]:
        """Min of a sub-sampler attribute, or None when any is unknown (lazy)."""
        values = [getattr(s, attr) for s in self.samplers]
        if any(v is None for v in values):
            return None
        return min(values)

    @property
    def remaining_duration(self) -> Optional[float]:
        return self._min_over("remaining_duration")

    @property
    def remaining_cuts(self) -> Optional[int]:
        return self._min_over("remaining_cuts")

    @property
    def num_cuts(self) -> Optional[int]:
        return self._min_over("num_cuts")

    def allow_iter_to_reset_state(self):
        super().allow_iter_to_reset_state()
        for s in self.samplers:
            s.allow_iter_to_reset_state()

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        sd["merge_batches"] = self.merge_batches
        sd["samplers"] = [s.state_dict() for s in self.samplers]
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.merge_batches = state_dict.pop("merge_batches")
        per_sampler = state_dict.pop("samplers")
        if len(per_sampler) != len(self.samplers):
            raise AssertionError(
                f"ZipSampler checkpoint mismatch: this sampler zips "
                f"{len(self.samplers)} sub-samplers but the state_dict was "
                f"saved with {len(per_sampler)}."
            )
        for sampler, sub_sd in zip(self.samplers, per_sampler):
            sampler.load_state_dict(sub_sd)
        super().load_state_dict(state_dict)

    def __iter__(self):
        for sampler in self.samplers:
            iter(sampler)
        return self

    def _next_batch(self) -> Union[CutSet, Tuple[CutSet, ...]]:
        self.allow_iter_to_reset_state()
        batches = [next(s) for s in self.samplers]
        if self.merge_batches:
            return _merge_batches(batches)
        return tuple(batches)

    def set_epoch(self, epoch: int) -> None:
        for s in self.samplers:
            s.set_epoch(epoch)
        super().set_epoch(epoch)

    def filter(self, predicate: Callable[[Cut], bool]) -> None:
        for sampler in self.samplers:
            sampler.filter(predicate)

    def _log_diagnostics(self, batch: Union[CutSet, Tuple[CutSet, ...]]) -> None:
        return  # sub-samplers log their own

    @property
    def diagnostics(self) -> SamplingDiagnostics:
        return reduce(add, (s.diagnostics for s in self.samplers))

    def get_report(self) -> str:
        return self.diagnostics.get_report()
