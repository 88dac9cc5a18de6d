"""
BucketingSampler: eager bucketing over an in-memory CutSet (copied from
``lhotse_tpu/dataset/sampling/bucketing.py``). Sorts cuts by duration into
equal-cumulative-duration buckets (filled from both ends toward the median),
runs one sub-sampler per bucket (which splits its batches between ranks),
and picks buckets by approximate proportional sampling (two random
candidates, weighted by remaining duration).
"""
import random
from copy import deepcopy
from functools import reduce
from operator import add
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, Union

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.dataset.sampling.base import CutSampler, SamplingDiagnostics
from lhotse_tpu_torch.dataset.sampling.simple import SimpleCutSampler


class BucketingSampler(CutSampler):
    """
    Buckets an eager CutSet by duration and runs a per-bucket sub-sampler
    (default :class:`SimpleCutSampler`). Yields batches from a random
    non-depleted bucket until all buckets are exhausted.

    Examples::

        >>> sampler = BucketingSampler(
        ...    cuts, sampler_type=SimpleCutSampler, num_buckets=20,
        ...    max_duration=200,
        ... )
    """

    def __init__(
        self, *cuts: CutSet, sampler_type: Type = SimpleCutSampler, num_buckets: int = 10,
        drop_last: bool = False, seed: int = 0, **kwargs: Any) -> None:
        # Distributed dedup is handled by the per-bucket sub-samplers, not here.
        super().__init__(drop_last=drop_last, world_size=1, rank=0, seed=seed)
        if any(cs.is_lazy for cs in cuts):
            raise ValueError(
                "BucketingSampler does not support working with lazy CutSet. "
                "Please use lhotse_tpu_torch.dataset.DynamicBucketingSampler instead."
            )
        self.num_buckets = num_buckets
        self.sampler_type = sampler_type
        self.sampler_kwargs = kwargs
        self.cut_sets = cuts
        self.buckets = create_buckets_equal_duration(*cuts, num_buckets=num_buckets)
        self.bucket_samplers = [
            sampler_type(*bucket, drop_last=drop_last, **kwargs)
            for bucket in self.buckets
        ]
        self.bucket_rng = random.Random(self.seed + self.epoch)
        self.depleted = [False] * num_buckets

    def _alive(self) -> List[Tuple[int, CutSampler]]:
        """(index, sampler) pairs of buckets that still have data."""
        return [(i, s) for i, s in enumerate(self.bucket_samplers) if not self.depleted[i]]

    def _sum_over_alive(self, attr: str) -> Optional[float]:
        values = [getattr(s, attr) for _, s in self._alive()]
        if any(v is None for v in values):
            return None
        return sum(values)

    remaining_duration = property(lambda self: self._sum_over_alive("remaining_duration"))
    remaining_cuts = property(lambda self: self._sum_over_alive("remaining_cuts"))

    @property
    def num_cuts(self) -> Optional[int]:
        counts = [s.num_cuts for s in self.bucket_samplers]
        return None if any(c is None for c in counts) else sum(counts)

    def set_epoch(self, epoch: int) -> None:
        for s in self.bucket_samplers:
            s.set_epoch(epoch)
        super().set_epoch(epoch)

    def filter(self, predicate: Callable[[Cut], bool]) -> None:
        for sampler in self.bucket_samplers:
            sampler.filter(predicate)

    def allow_iter_to_reset_state(self):
        super().allow_iter_to_reset_state()
        for s in self.bucket_samplers:
            s.allow_iter_to_reset_state()

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        sd["num_buckets"] = self.num_buckets
        sd["depleted"] = list(self.depleted)
        sd["bucket_samplers"] = [s.state_dict() for s in self.bucket_samplers]
        sd["sampler_kwargs"] = deepcopy(self.sampler_kwargs)
        sd["bucket_rng_state"] = self.bucket_rng.getstate()
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        saved_buckets = state_dict.pop("num_buckets")
        if saved_buckets != self.num_buckets:
            raise AssertionError(
                f"BucketingSampler checkpoint mismatch: this sampler has "
                f"{self.num_buckets} buckets, the state_dict was saved with "
                f"{saved_buckets}."
            )
        self.sampler_kwargs = state_dict.pop("sampler_kwargs")
        self.depleted = state_dict.pop("depleted")
        rng_state = state_dict.pop("bucket_rng_state")
        # JSON round-trips turn tuples into lists; random.setstate needs tuples.
        if isinstance(rng_state, list):
            rng_state = (rng_state[0], tuple(rng_state[1]), rng_state[2])
        self.bucket_rng.setstate(rng_state)

        per_bucket = state_dict.pop("bucket_samplers")
        if len(per_bucket) != len(self.bucket_samplers):
            raise AssertionError(
                f"BucketingSampler checkpoint mismatch: this sampler has "
                f"{len(self.bucket_samplers)} sub-samplers, the state_dict "
                f"was saved with {len(per_bucket)}."
            )
        for sampler, sub_sd in zip(self.bucket_samplers, per_bucket):
            sampler.load_state_dict(sub_sd)
        super().load_state_dict(state_dict)

    def __iter__(self) -> "BucketingSampler":
        if self._just_restored_state:
            return self
        self.diagnostics.reset_current_epoch()
        self.bucket_rng.seed(self.seed + self.epoch)
        for b in self.bucket_samplers:
            iter(b)
        self.depleted = [False] * self.num_buckets
        return self

    def _pick_bucket(self) -> Tuple[int, CutSampler]:
        candidates = self._alive()
        if len(candidates) == 1:
            return candidates[0]
        # Approximate proportional sampling: draw two candidate buckets and
        # prefer the one with more data left, so buckets deplete together.
        first = self.bucket_rng.choice(candidates)
        second = self.bucket_rng.choice(candidates)
        left = first[1].remaining_duration
        both = left + second[1].remaining_duration
        if both == 0:
            # Both candidates are empty but not yet marked depleted (that only
            # happens when next() raises). Just pick one.
            return first
        return second if self.bucket_rng.random() > left / both else first

    def _next_batch(self):
        self.allow_iter_to_reset_state()
        while not self.is_depleted:
            idx, sampler = self._pick_bucket()
            try:
                return next(sampler)
            except StopIteration:
                self.depleted[idx] = True
        raise StopIteration()

    @property
    def is_depleted(self) -> bool:
        return all(self.depleted)

    def _log_diagnostics(self, batch: Union[CutSet, Tuple[CutSet, ...]]) -> None:
        return  # sub-samplers log their own

    @property
    def diagnostics(self) -> SamplingDiagnostics:
        return reduce(add, (bucket.diagnostics for bucket in self.bucket_samplers))

    def get_report(self) -> str:
        return self.diagnostics.get_report()


def create_buckets_equal_duration(*cuts: CutSet, num_buckets: int) -> List[Tuple[CutSet, ...]]:
    """
    Partition CutSets into buckets of equal cumulative duration. The first
    CutSet defines the bucketing; additional CutSets (paired by cut ID)
    follow its assignment.
    """
    lead = cuts[0].sort_by_duration(ascending=True)
    lead_buckets = _equal_duration_buckets(lead, num_buckets=num_buckets)
    per_cutset = [lead_buckets]
    for follower in cuts[1:]:
        per_cutset.append([follower.subset(cut_ids=bucket.ids) for bucket in lead_buckets])
    return list(zip(*per_cutset))


def _equal_duration_buckets(cuts: CutSet, num_buckets: int) -> List[CutSet]:
    """
    Fill buckets from both ends of the duration-sorted list toward the middle
    (shortest cuts stream into bucket 0 upward, longest into the last bucket
    downward), so overflow near the median splits between the two central
    buckets instead of piling up in the last one.

    Matched EXACTLY to the reference (sampling/bucketing.py:365-427),
    including its middle-bucket overflow redirection (once both streams meet
    in one bucket, further overflow spills into the buckets adjacent to it)
    and the final within-bucket ordering (ascending by duration, not stream
    arrival) — bucket composition decides seeded batch order downstream.
    """
    ordered = list(cuts)  # already duration-sorted ascending
    n = len(ordered)
    durations = [c.duration for c in ordered]
    target = sum(durations) / num_buckets

    lo, hi = 0, n - 1
    first, last = 0, num_buckets - 1
    middle = None
    fill = [0.0] * num_buckets
    assignment = {}
    for i in range(1, n + 1):
        if middle is None and first == last:
            middle = first
        if i % 2:  # left stream: next shortest remaining cut
            pos, lo = lo, lo + 1
            d = durations[pos]
            if fill[first] + d > target:
                if middle is not None and first == middle:
                    first = max(0, min(middle - 1, num_buckets - 1))
                else:
                    first = min(first + 1, num_buckets - 1)
            fill[first] += d
            assignment[pos] = first
        else:  # right stream: next longest remaining cut
            pos, hi = hi, hi - 1
            d = durations[pos]
            if fill[last] + d > target:
                if middle is not None and last == middle:
                    last = max(middle + 1, 0)
                else:
                    last = max(last - 1, 0)
            fill[last] += d
            assignment[pos] = last

    bins: List[List[Cut]] = [[] for _ in range(num_buckets)]
    for pos, cut in enumerate(ordered):
        bins[assignment[pos]].append(cut)
    return [CutSet.from_cuts(b) for b in bins]
