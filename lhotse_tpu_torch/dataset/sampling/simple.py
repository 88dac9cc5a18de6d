"""
SimpleCutSampler: dynamic-batch-size sampling from a single CutSet (copied
from ``lhotse_tpu/dataset/sampling/simple.py``): constraint-driven batch
collection with take-back of the overflowing cut, the ``drop_last``
override when the batch is close to its limit, and a fast-forward restore
keyed on the diagnostics' per-epoch cut count.
"""
import warnings
from typing import Any, Dict, Optional

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.sampling.base import CutSampler, TimeConstraint
from lhotse_tpu_torch.dataset.sampling.data_source import DataSource
from lhotse_tpu_torch.utils import Seconds


class SimpleCutSampler(CutSampler):
    """
    Samples cuts to satisfy a :class:`TimeConstraint`; yields CutSet batches
    of dynamic size. Exactly zero or one of ``max_duration``/``max_cuts`` may
    bound the batch; padding cost is modeled by the constraint itself.

    Example::

        >>> sampler = SimpleCutSampler(cuts, max_duration=200.0, shuffle=True)
        >>> for epoch in range(n_epochs):
        ...     sampler.set_epoch(epoch)
        ...     for batch in sampler: ...
    """

    def __init__(
        self, cuts: CutSet, max_duration: Seconds = None, max_cuts: Optional[int] = None,
        shuffle: bool = False, drop_last: bool = False, concatenate_cuts: bool = False,
        quadratic_duration: Optional[Seconds] = None, world_size: Optional[int] = None,
        rank: Optional[int] = None, seed: int = 0):
        super().__init__(
            drop_last=drop_last, shuffle=shuffle, world_size=world_size, rank=rank, seed=seed)
        assert any(v is not None for v in (max_duration, max_cuts)), (
            "At least one of max_duration or max_cuts has to be set."
        )
        self.cuts = [cuts]  # enables CutSampler source-state capture
        self.data_source = DataSource(cuts)
        self.time_constraint = TimeConstraint(
            max_duration=max_duration, max_cuts=max_cuts, concatenate_cuts=concatenate_cuts,
            quadratic_duration=quadratic_duration)

    # Progress accounting (each is None for lazy CutSets).
    remaining_duration = property(lambda self: self.data_source.remaining_duration)
    remaining_cuts = property(lambda self: self.data_source.remaining_cuts)
    num_cuts = property(lambda self: None if self.data_source.is_lazy else len(self.data_source))

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        sd["time_constraint"] = self.time_constraint.state_dict()
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """
        Restore sampler progress. The sampler must be constructed with the
        same CutSet. The input dict is consumed (keys popped).
        """
        time_constraint = TimeConstraint(**state_dict.pop("time_constraint"))
        if self.time_constraint != time_constraint:
            warnings.warn(
                "SimpleCutSampler.load_state_dict(): Inconsistent time_constraint:\n"
                f"expected {self.time_constraint}\n"
                f"received {time_constraint}\n"
                "We will overwrite the settings with the received state_dict."
            )
        self.time_constraint = time_constraint
        super().load_state_dict(state_dict)
        # Replay-based restore: reshuffle to the right epoch order and skip
        # the cuts already consumed this epoch.
        if hasattr(self.data_source, "set_epoch"):
            self.data_source.set_epoch(self.epoch)
        if self.shuffle:
            self.data_source.shuffle(self.seed + self.epoch)
        self.data_source.fast_forward(self.diagnostics.current_epoch_stats.consumed_cuts)

    def __iter__(self) -> "SimpleCutSampler":
        if self._just_restored_state:
            return self
        # Re-iterating the same epoch must reset its stats, otherwise a later
        # checkpoint would record more steps than the epoch contains.
        self.diagnostics.reset_current_epoch()
        if self.shuffle:
            self.data_source.shuffle(self.seed + self.epoch)
        iter(self.data_source)
        return self

    def _source_exhausted(self, collected) -> CutSet:
        """End-of-source: emit the partial batch unless drop_last forbids it."""
        keep_partial = not self.drop_last or self.time_constraint.close_to_exceeding()
        if collected and keep_partial:
            return CutSet.from_cuts(collected)
        self.diagnostics.discard(collected)
        raise StopIteration()

    def _next_batch(self) -> CutSet:
        # Collect cuts until the constraint trips; metadata only — no audio IO.
        self.time_constraint.reset()
        collected = []
        while True:
            try:
                cut = next(self.data_source)
            except StopIteration:
                return self._source_exhausted(collected)

            if not self._filter_fn(cut):
                self.diagnostics.discard_single(cut)
                continue

            self.time_constraint.add(cut)
            if not self.time_constraint.exceeded():
                collected.append(cut)
                continue
            if not collected:
                warnings.warn(
                    "The first cut drawn in batch collection violates "
                    "the max_duration, or max_cuts constraints - "
                    "we'll return it anyway. "
                    "Consider increasing max_duration/max_cuts."
                )
                collected.append(cut)
            else:
                # Keep the overflowing cut for the next batch.
                self.data_source.take_back(cut)
            return CutSet.from_cuts(collected)
