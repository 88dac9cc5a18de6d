"""
DataSource: re-shufflable iterator over a CutSet with a "take back" queue
(copied from ``lhotse_tpu/dataset/sampling/data_source.py``), which the
eager samplers draw from, and ``WeightedDataSource``, which draws
``num_samples`` cuts per epoch by weight, without replacement, from a
generator seeded with ``seed + epoch``.
"""
from collections import deque
from typing import List, Optional

import numpy as np

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


class WeightedDataSource(DataSource):
    """
    DataSource that draws ``num_samples`` cuts per epoch from a multinomial
    distribution without replacement, with per-cut weights.
    """

    def __init__(self, items: CutSet, weights: List, num_samples: int, seed: int = 0):
        super().__init__(items=items)
        assert len(items) == len(weights), (
            f"Expected one weight per cut ({len(items)} cuts, {len(weights)} weights)."
        )
        assert num_samples < len(weights), (
            "The number of samples to be drawn must not exceed the dataset size."
        )
        weights = np.asarray(weights, dtype=np.float64)
        assert (weights > 0).all(), "All sampling weights must be positive."
        self.weights = weights / weights.sum()
        self.num_samples = num_samples
        self.seed = seed
        self.epoch = 0
        self.sampled_indexes = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def reset(self) -> None:
        super().reset()
        self.sampled_indexes = None

    def fast_forward(self, steps: int) -> None:
        assert steps >= 0
        iter(self)
        for _ in range(steps):
            next(self.sampled_indexes)

    def __iter__(self) -> "WeightedDataSource":
        self.reset()
        self._iter = iter(self._shuffled_items)
        # Seeded per-epoch draw: reproducible and identical across ranks.
        rng = np.random.default_rng(self.seed + self.epoch)
        drawn = rng.choice(len(self.weights), self.num_samples, p=self.weights, replace=False)
        self.sampled_indexes = iter(drawn)
        return self

    def __next__(self) -> Cut:
        if self._reusable:
            next_cut = self._reusable.popleft()
        else:
            next_cut = self._orig_items[int(next(self.sampled_indexes))]
        if not self.is_lazy:
            self._remaining_duration -= next_cut.duration
            self.remaining_cuts -= 1
        return next_cut
