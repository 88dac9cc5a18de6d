"""
DataSource: re-shufflable iterator over a CutSet with a "take back" queue
(copied from ``lhotse_tpu/dataset/sampling/data_source.py``), which the
eager samplers draw from. ``WeightedDataSource`` is not ported.
"""
from collections import deque
from typing import Optional

from lhotse_tpu_torch.cut import Cut, CutSet


class DataSource:
    """
    Iterator wrapper over CutSet used by samplers: supports deterministic
    re-shuffling per epoch and "returning" a sampled cut so it is yielded
    again (when a batch closes with one cut drawn too many).
    """

    def __init__(self, items: CutSet):
        self._orig_items = items
        self._shuffled_items = items
        self._iter = None
        self._reusable = deque()
        # Duration bookkeeping is only possible for eager CutSets.
        self._total_duration = self._total_cuts = None
        if not self.is_lazy:
            self._total_duration = sum(c.duration for c in items)
            self._total_cuts = len(items)
        self._remaining_duration = self._total_duration
        self.remaining_cuts = self._total_cuts

    @property
    def is_lazy(self) -> bool:
        return self._orig_items.is_lazy

    @property
    def remaining_duration(self) -> Optional[float]:
        if self._remaining_duration is None:
            return None
        # Guard against float drift going slightly negative.
        return max(0, self._remaining_duration)

    def shuffle(self, seed: int) -> "DataSource":
        """Deterministically shuffle (streaming buffered shuffle when lazy)."""
        import random

        self.reset()
        r = random.Random(seed)
        self._shuffled_items = self._orig_items.shuffle(rng=r)
        return self

    def sort_like(self, other: "DataSource") -> "DataSource":
        """Reorder to match the cut-id order of another DataSource."""
        self.reset()
        self._shuffled_items = self._orig_items.sort_like(other._shuffled_items)
        return self

    def take_back(self, cut: Cut) -> None:
        """Push the cut back so it is sampled again before new items."""
        self._reusable.append(cut)
        if not self.is_lazy:
            self.remaining_cuts += 1
            self._remaining_duration += cut.duration

    def reset(self) -> None:
        self._iter = None
        self._reusable.clear()
        self.remaining_cuts = self._total_cuts
        self._remaining_duration = self._total_duration

    def fast_forward(self, steps: int) -> None:
        """Advance by ``steps`` items (used for O(N) checkpoint replay)."""
        assert steps >= 0
        iter(self)
        for _ in range(steps):
            next(self)

    def __iter__(self) -> "DataSource":
        self.reset()
        self._iter = iter(self._shuffled_items)
        return self

    def __next__(self) -> Cut:
        if self._reusable:
            next_cut = self._reusable.popleft()
        else:
            next_cut = next(self._iter)
        if not self.is_lazy:
            self._remaining_duration -= next_cut.duration
            self.remaining_cuts -= 1
        return next_cut

    def __len__(self) -> int:
        return len(self._shuffled_items)
