"""
RoundRobinSampler: alternate mini-batches between several samplers (copied
from ``lhotse_tpu/dataset/sampling/round_robin.py``): in-order or
probability-weighted selection, a start index offset per dataloading
worker, depleted samplers skipped until all are exhausted (or
``stop_early``).
"""
from functools import reduce
from operator import add
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.dataset.sampling.base import CutSampler, SamplingDiagnostics

# Scalar scheduling state that round-trips through state_dict unchanged.
_SCHED_KEYS = ("stop_early", "randomize", "_cur_sampler_idx", "_num_dl_workers")


class RoundRobinSampler(CutSampler):
    """
    Yields one mini-batch from each input sampler in turn — useful for
    alternating between datasets or manually mixing batch sizes::

        >>> sampler = RoundRobinSampler(
        ...     SimpleCutSampler(cuts_corpusA, max_cuts=32, shuffle=True),
        ...     SimpleCutSampler(cuts_corpusB, max_cuts=64, shuffle=True),
        ... )
    """

    def __init__(
        self, *samplers: CutSampler, stop_early: bool = False,
        randomize: Union[bool, List[float]] = False, seed: int = 0) -> None:
        """
        :param samplers: samplers to draw batches from in turns.
        :param stop_early: finish the epoch as soon as any sampler depletes
            (balances datasets of different sizes).
        :param randomize: False = strict order; True = uniform random choice;
            a list of floats = per-sampler selection probabilities.
        :param seed: seed for the random selection (randomize only).
        """
        super().__init__(rank=0, world_size=1, seed=seed)
        self.samplers = samplers
        self.stop_early = stop_early
        self.rng = None
        self._nondepleted_samplers_indices = list(range(len(samplers)))
        self._cur_sampler_idx = 0
        self._num_dl_workers = 1
        if randomize is True:
            randomize = [1.0 / len(samplers)] * len(samplers)
        elif isinstance(randomize, list) and len(randomize) != len(samplers):
            raise AssertionError(
                f"randomize got {len(randomize)} probabilities for "
                f"{len(samplers)} samplers."
            )
        self.randomize = randomize

    def _sum_over(self, attr: str) -> Optional[Union[int, float]]:
        """Sum of a sub-sampler attribute, or None when any is unknown (lazy)."""
        values = [getattr(s, attr) for s in self.samplers]
        if any(v is None for v in values):
            return None
        return sum(values)

    @property
    def remaining_duration(self) -> Optional[float]:
        return self._sum_over("remaining_duration")

    @property
    def remaining_cuts(self) -> Optional[int]:
        return self._sum_over("remaining_cuts")

    @property
    def num_cuts(self) -> Optional[int]:
        return self._sum_over("num_cuts")

    def allow_iter_to_reset_state(self):
        super().allow_iter_to_reset_state()
        for s in self.samplers:
            s.allow_iter_to_reset_state()

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        for key in _SCHED_KEYS:
            sd[key] = getattr(self, key)
        sd["samplers"] = [s.state_dict() for s in self.samplers]
        # List copy allows in-process restore.
        sd["_nondepleted_samplers_indices"] = list(self._nondepleted_samplers_indices)
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        for key in _SCHED_KEYS:
            setattr(self, key, state_dict.pop(key))
        self._nondepleted_samplers_indices = state_dict.pop("_nondepleted_samplers_indices")
        per_sampler = state_dict.pop("samplers")
        if len(per_sampler) != len(self.samplers):
            raise AssertionError(
                f"RoundRobinSampler checkpoint mismatch: this sampler rotates "
                f"over {len(self.samplers)} sub-samplers but the state_dict "
                f"was saved with {len(per_sampler)}."
            )
        for sampler, sub_sd in zip(self.samplers, per_sampler):
            sampler.load_state_dict(sub_sd)
        super().load_state_dict(state_dict)

    def __iter__(self):
        from lhotse_tpu_torch.dataset.dataloading import get_worker_info

        self.rng = np.random.default_rng(seed=self.seed + self.epoch)
        for sampler in self.samplers:
            iter(sampler)
        if self._just_restored_state:
            return self
        self._nondepleted_samplers_indices = list(range(len(self.samplers)))
        # Inside a dataloading worker, offset the starting index per worker so
        # N workers don't all pick the same sub-sampler for N consecutive
        # mini-batches.
        worker_info = get_worker_info()
        if worker_info is None:
            self._cur_sampler_idx, self._num_dl_workers = 0, 1
        else:
            self._cur_sampler_idx = worker_info.id % len(self.samplers)
            self._num_dl_workers = worker_info.num_workers
        return self

    def _next_batch(self) -> Union[CutSet, Tuple[CutSet]]:
        while True:
            alive = self._nondepleted_samplers_indices
            if not alive:
                raise StopIteration()
            sampler = self.samplers[alive[self._cur_sampler_idx]]
            try:
                batch = next(sampler)
            except StopIteration:
                alive.pop(self._cur_sampler_idx)
                if self.stop_early or not alive:
                    raise
                self._set_next_idx()
                continue
            self._set_next_idx()
            return batch

    def _set_next_idx(self) -> None:
        alive = self._nondepleted_samplers_indices
        if self.randomize is not False and len(alive) > 1:
            weights = np.asarray([self.randomize[i] for i in alive], dtype=float)
            weights /= weights.sum()
            self._cur_sampler_idx = int(
                self.rng.choice(len(alive), size=1, replace=False, p=weights)[0]
            )
        else:
            step = self._cur_sampler_idx + self._num_dl_workers
            self._cur_sampler_idx = step % max(1, len(alive))

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
