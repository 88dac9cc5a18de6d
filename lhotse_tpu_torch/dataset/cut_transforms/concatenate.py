"""
CutConcatenate and ``concat_cuts``: greedy packing of a batch's short cuts
into longer ``MixedCut``s separated by silence, which cuts the padding of
the collated batch (copied from
``lhotse_tpu/dataset/cut_transforms/concatenate.py``).
"""
from typing import Optional, Sequence

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.utils import Seconds


class CutConcatenate:
    """
    Batch transform that merges short cuts into longer ones (separated by a
    silence ``gap``) to minimize the total padding in the collated batch.
    """

    def __init__(
        self, gap: Seconds = 1.0, duration_factor: float = 1.0,
        max_duration: Optional[Seconds] = None) -> None:
        """
        :param gap: silence inserted between concatenated utterances, so the
            model can tell they are separate.
        :param duration_factor: cap on the concatenated duration relative to
            the longest cut in the batch (ignored if max_duration is set).
        :param max_duration: absolute cap on concatenated duration (seconds).
        """
        self.gap = gap
        self.duration_factor = duration_factor
        self.max_duration = max_duration

    def __call__(self, cuts: CutSet) -> CutSet:
        cuts = cuts.sort_by_duration(ascending=False)
        return concat_cuts(
            list(cuts), gap=self.gap,
            max_duration=self.max_duration if self.max_duration else cuts[0].duration * self.duration_factor,
        )


def concat_cuts(
    cuts: Sequence[Cut], gap: Seconds = 1.0, max_duration: Optional[Seconds] = None) -> CutSet:
    """
    Greedy knapsack packing: from the shortest cut upward, append it to the
    longest cut that still has room (duration + gap + shortest <= cap).
    """
    if len(cuts) <= 1:
        return CutSet.from_cuts(cuts)
    cuts = sorted(cuts, key=lambda c: c.duration, reverse=True)
    max_duration = cuts[0].duration if max_duration is None else max_duration
    current_idx = 0
    while True:
        can_fit = False
        shortest = cuts[-1]
        for idx in range(current_idx, len(cuts) - 1):
            cut = cuts[current_idx]
            can_fit = cut.duration + gap + shortest.duration <= max_duration
            if can_fit:
                cuts[current_idx] = cut.pad(cut.duration + gap).append(shortest)
                cuts = cuts[:-1]
                break
            current_idx += 1
        if not can_fit:
            break
    return CutSet.from_cuts(cuts)
