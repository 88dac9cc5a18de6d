"""
CutPairsSampler: paired sampling from source/target CutSets by matching IDs
(copied from ``lhotse_tpu/dataset/sampling/cut_pairs.py``): separate
source/target TimeConstraints; a batch closes when either side exceeds;
partial-batch and take-back semantics mirror SimpleCutSampler.
"""
import warnings
from typing import Any, Dict, Optional, Tuple

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.sampling.base import CutSampler, TimeConstraint
from lhotse_tpu_torch.dataset.sampling.data_source import DataSource
from lhotse_tpu_torch.utils import Seconds

_PAIR_DESYNC = (
    "Unexpected state: some cuts in source / target are missing their "
    "counterparts..."
)


class CutPairsSampler(CutSampler):
    """
    Samples pairs of cuts from a "source" and "target" CutSet that strictly
    consist of cuts with corresponding IDs (same length, same order). The
    batch size is dynamic under ``max_source_duration`` /
    ``max_target_duration`` / ``max_cuts``.
    """

    def __init__(
        self, source_cuts: CutSet, target_cuts: CutSet, max_source_duration: Seconds = None,
        max_target_duration: Seconds = None, max_cuts: Optional[int] = None, shuffle: bool = False,
        drop_last: bool = False, world_size: Optional[int] = None, rank: Optional[int] = None,
        seed: int = 0):
        super().__init__(
            drop_last=drop_last, shuffle=shuffle, world_size=world_size, rank=rank, seed=seed)
        self.source_cuts = DataSource(source_cuts)
        self.target_cuts = DataSource(target_cuts)
        self.source_constraints = TimeConstraint(
            max_duration=max_source_duration, max_cuts=max_cuts)
        self.target_constraints = TimeConstraint(
            max_duration=max_target_duration, max_cuts=max_cuts)

    # Progress accounting follows the source stream (None for lazy CutSets).
    remaining_duration = property(lambda self: self.source_cuts.remaining_duration)
    remaining_cuts = property(lambda self: self.source_cuts.remaining_cuts)
    num_cuts = property(lambda self: None if self.source_cuts.is_lazy else len(self.source_cuts))

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        sd["source_constraints"] = self.source_constraints.state_dict()
        sd["target_constraints"] = self.target_constraints.state_dict()
        return sd

    def _restore_constraint(self, side: str, state_dict: Dict[str, Any]) -> None:
        attr = f"{side}_constraints"
        incoming = TimeConstraint(**state_dict.pop(attr))
        if getattr(self, attr) != incoming:
            warnings.warn(
                f"CutPairsSampler.load_state_dict(): Inconsistent {side}_constraint:\n"
                f"expected {getattr(self, attr)}\n"
                f"received {incoming}\n"
                "We will overwrite the settings with the received state_dict."
            )
        setattr(self, attr, incoming)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self._restore_constraint("source", state_dict)
        self._restore_constraint("target", state_dict)
        super().load_state_dict(state_dict)
        self._reshuffle_streams()
        consumed = self.diagnostics.current_epoch_stats.consumed_cuts
        self.source_cuts.fast_forward(consumed)
        self.target_cuts.fast_forward(consumed)

    def _reshuffle_streams(self) -> None:
        if self.shuffle:
            for stream in (self.source_cuts, self.target_cuts):
                stream.shuffle(self.seed + self.epoch)

    def __iter__(self) -> "CutPairsSampler":
        if self._just_restored_state:
            return self
        self.diagnostics.reset_current_epoch()
        self._reshuffle_streams()
        iter(self.source_cuts)
        iter(self.target_cuts)
        return self

    def _emit(self, pairs) -> Tuple[CutSet, CutSet]:
        src, tgt = zip(*pairs) if pairs else ((), ())
        assert len(src) == len(tgt), _PAIR_DESYNC
        return CutSet.from_cuts(src), CutSet.from_cuts(tgt)

    def _next_batch(self) -> Tuple[CutSet, CutSet]:
        # Metadata-only batch collection over both streams in lockstep.
        self.source_constraints.reset()
        self.target_constraints.reset()
        pairs = []
        while True:
            try:
                src = next(self.source_cuts)
                tgt = next(self.target_cuts)
            except StopIteration:
                nearly_full = (
                    self.source_constraints.close_to_exceeding()
                    or self.target_constraints.close_to_exceeding()
                )
                if pairs and (not self.drop_last or nearly_full):
                    return self._emit(pairs)
                self.diagnostics.discard([s for s, _ in pairs])
                raise StopIteration()

            assert src.id == tgt.id, (
                "Sampled source and target cuts with differing IDs. "
                "Ensure that your source and target cuts have the same "
                "length, the same IDs, and the same order."
            )

            if not (self._filter_fn(src) and self._filter_fn(tgt)):
                self.diagnostics.discard_single(src)
                continue

            self.source_constraints.add(src)
            self.target_constraints.add(tgt)
            overflow = (self.source_constraints.exceeded() or self.target_constraints.exceeded())
            if not overflow:
                pairs.append((src, tgt))
                continue
            if not pairs:
                warnings.warn(
                    "The first cut drawn in batch collection violates one "
                    "of the max_... constraints; we'll return it anyway. "
                    "Consider increasing max_source_duration/max_cuts/etc."
                )
                pairs.append((src, tgt))
            else:
                self.source_cuts.take_back(src)
                self.target_cuts.take_back(tgt)
            return self._emit(pairs)
