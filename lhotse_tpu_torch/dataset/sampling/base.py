"""
Sampler foundations (copied from ``lhotse_tpu/dataset/sampling/base.py``):
the CutSampler protocol with map-style DDP semantics (every ``next()``
draws ``world_size`` batches and this rank keeps ``batches[rank]``; at the
end of the data the stragglers are redistributed so every rank steps the
same number of times), the duration and cut-count constraint, its token
analog for text sampling (``TokenConstraint`` over ``TextExample``s), and
the sampling diagnostics.
"""
from __future__ import annotations

import copy
import warnings
from abc import ABCMeta, abstractmethod
from bisect import bisect_left
from copy import deepcopy
from dataclasses import asdict, dataclass
from math import isclose
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.cut.text import TextExample
from lhotse_tpu_torch.lazy import Dillable, IteratorNode
from lhotse_tpu_torch.utils import Seconds, exactly_one_not_null, ifnone, is_none_or_gt


def drain_state(owner: str, state: Dict[str, Any], target: Any, required=(), optional=()) -> None:
    """Pop ``required`` and ``optional`` ``(key, default)`` entries out of a
    checkpoint dict onto ``target``'s attributes, then insist the dict is
    empty — leftovers mean version skew between writer and reader."""
    for key in required:
        setattr(target, key, state.pop(key))
    for key, default in optional:
        setattr(target, key, state.pop(key, default))
    if state:
        leftovers = "\n- ".join(state.keys())
        raise AssertionError(f"{owner}.load_state_dict(): unexpected keys:\n- {leftovers}")


def _capture_source_state(src) -> Optional[dict]:
    from lhotse_tpu_torch.checkpoint import collect_state_dict

    grab = src.state_dict if isinstance(src, CutSet) else (
        (lambda: collect_state_dict(src)) if isinstance(src, IteratorNode) else lambda: None)
    return grab()


def capture_sources_state(sources) -> Optional[list]:
    """Per-source iterator-graph states; None when nothing is capturable."""
    if not isinstance(sources, (list, tuple)):
        return None

    def grab_or_none(src):
        try:
            return _capture_source_state(src)
        except Exception:
            return None

    states = [grab_or_none(src) for src in sources]
    return None if all(st is None for st in states) else states


def restore_sources_state(sources, cuts_state: Optional[list]) -> None:
    from lhotse_tpu_torch.checkpoint import restore_state_dict

    pairs = [(s, st) for s, st in zip(sources, cuts_state or ()) if st is not None]
    for src, state in pairs:
        if isinstance(src, CutSet):
            src.load_state_dict(state)
        elif isinstance(src, IteratorNode):
            restore_state_dict(src, state)


class _accept_everything:
    """Default cut filter; its type marks 'no user filter installed yet'."""

    def __call__(self, cut: Cut) -> bool: return True  # noqa: E704


def _both(first: Callable[[Cut], bool], second: Callable[[Cut], bool]):
    return lambda cut: first(cut) and second(cut)


def mark_as_duplicate(iteration: int) -> Callable[[str], str]:
    return lambda cut_id: f"{cut_id}_dup{iteration}"


def attach_dataloading_info(cuts: CutSet, rank: int, world_size: int) -> None:
    """Stamp each cut with its {rank, world_size, worker_id} provenance."""
    from lhotse_tpu_torch.dataset.dataloading import get_worker_info

    wi = get_worker_info()
    stamp = {"rank": rank, "world_size": world_size, "worker_id": None if wi is None else wi.id}
    for cut in cuts:
        cut.dataloading_info = stamp


class CutSampler(Dillable):
    """
    Base of all samplers: assembles batches of cut *metadata* under pluggable
    constraints; no audio or feature I/O happens here.  Subclasses implement
    ``__iter__`` (epoch setup) and ``_next_batch`` (one batch).
    """

    def __init__(
        self, shuffle: bool = False, drop_last: bool = False, world_size: Optional[int] = None,
        rank: Optional[int] = None, seed: Union[int, str] = 0) -> None:
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self._diagnostics = SamplingDiagnostics()
        # Flipped by load_state_dict so the next iter() resumes, not resets.
        self._just_restored_state = False
        self._resolve_topology(world_size, rank)
        self._filter_fn: Callable[[Cut], bool] = _accept_everything()
        self._transforms = []

    @property
    def diagnostics(self):
        """Kept/discarded cut and batch counters, per epoch."""
        return self._diagnostics

    def _resolve_topology(self, world_size: Optional[int], rank: Optional[int]):
        from lhotse_tpu_torch.dataset.dataloading import get_rank, get_world_size

        # Precedence: explicit args > env vars > JAX process runtime > (1, 0).
        self.world_size = ifnone(world_size, get_world_size())
        self.rank = ifnone(rank, get_rank())
        if self.world_size < 1 or not 0 <= self.rank < self.world_size:
            raise AssertionError(
                f"Bad sampler topology: rank={self.rank}, world_size={self.world_size}"
            )

    # Kept for parity with earlier revisions / reference naming.
    def set_epoch(self, epoch: int) -> None:
        """Change the epoch (and with it the shuffle order when shuffling)."""
        if self._just_restored_state or getattr(self, "_needs_fast_forward", False):
            return  # don't clobber freshly-restored iteration state
        if self.epoch != epoch:
            self.allow_iter_to_reset_state()
        self.epoch = epoch
        self.diagnostics.set_epoch(epoch)

    def filter(self, predicate: Callable[[Cut], bool]) -> "CutSampler":
        """Only consider cuts satisfying ``predicate`` (AND-composes)."""
        if isinstance(self._filter_fn, _accept_everything):
            self._filter_fn = predicate
        else:
            self._filter_fn = _both(self._filter_fn, predicate)
        return self

    def map(self, fn: Callable[[CutSet], CutSet]) -> "CutSampler":
        """Post-process each emitted mini-batch CutSet with ``fn``."""
        if not callable(fn):
            raise AssertionError(
                f"Expected a callable accepting and returning a CutSet, received: '{fn}'"
            )
        self._transforms.append(fn)
        return self

    # -- checkpointing -------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """
        Everything needed for exact resume: epoch + topology + diagnostics,
        the source graph state when capturable (enables O(1) restore), and
        RNG states of stateful batch transforms.
        """
        sd = {
            "epoch": self.epoch, "drop_last": self.drop_last, "world_size": self.world_size,
            "rank": self.rank, "seed": self.seed, "shuffle": self.shuffle,
            "diagnostics": self.diagnostics.state_dict()}
        source_state = self._capture_cuts_state()
        if source_state is not None:
            sd["cuts_state"] = source_state
        if self._transforms:
            sd["transforms_state"] = [
                t.state_dict() if hasattr(t, "state_dict") else None
                for t in self._transforms
            ]
        return sd

    def _capture_cuts_state(self) -> Optional[list]:
        return capture_sources_state(getattr(self, "cuts", None))

    def _restore_cuts_state(self, cuts_state: Optional[list]) -> None:
        restore_sources_state(getattr(self, "cuts", ()), cuts_state)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """
        Consume a checkpoint (pops keys from the dict).  The sampler must be
        constructed over the same CutSets with the same topology and seed.
        """
        self.drop_last = state_dict.pop("drop_last")
        # Topology/seed must agree between writer and reader; rank skew gets a
        # RuntimeError (it is an orchestration bug, not a usage bug).
        pinned = (
            ("world_size", self.world_size, AssertionError,
             "Cannot restore sampler with a different world_size (current {cur}, checkpoint {ckpt})."),
            ("rank", self.rank, RuntimeError,
             "CutSampler.load_state_dict: state was saved on rank={ckpt} but is being loaded on rank={cur}."),
            ("seed", self.seed, AssertionError,
             "Seed mismatch on sampler restore: {cur} vs checkpoint {ckpt}"))
        for key, current, err_type, template in pinned:
            ckpt_value = state_dict.pop(key)
            if ckpt_value != current:
                raise err_type(template.format(cur=current, ckpt=ckpt_value))
        saved_shuffle = state_dict.pop("shuffle")
        if self.shuffle != saved_shuffle:
            warnings.warn(
                "Overriding the shuffle value in CutSampler based on state_dict "
                f"(initialized to {self.shuffle}; restored to {saved_shuffle})."
            )
        self.shuffle = saved_shuffle
        self.diagnostics.load_state_dict(state_dict.pop("diagnostics"))
        self._cuts_state = state_dict.pop("cuts_state", None)
        self._transforms_state = state_dict.pop("transforms_state", None)
        drain_state("CutSampler", state_dict, self, required=("epoch",))
        self._just_restored_state = True

    def _restore_transforms_state(self) -> None:
        """Put back stateful transform RNGs (O(1) restore path only; the O(N)
        replay path advances them naturally)."""
        saved = getattr(self, "_transforms_state", None)
        if saved is None:
            return
        for t, ts in zip(self._transforms, saved):
            if ts is not None and hasattr(t, "load_state_dict"):
                t.load_state_dict(ts)
        self._transforms_state = None

    def allow_iter_to_reset_state(self):
        """Forget restored in-epoch progress; next iter() starts the epoch over."""
        self._just_restored_state = False
        if hasattr(self, "_needs_fast_forward"):
            self._needs_fast_forward = False
        for attr in ("_cuts_state", "_transforms_state", "_rng_state", "_bucketer_state"):
            if hasattr(self, attr):
                setattr(self, attr, None)

    # -- abstract surface -------------------------------------------------------------

    def __iter__(self):
        raise NotImplementedError("Sub-classes of CutSampler must implement __iter__()")

    def _next_batch(self):
        raise NotImplementedError("Sub-classes of CutSampler must implement self._next_batch()")

    @property
    def remaining_duration(self) -> Optional[float]:
        raise NotImplementedError

    @property
    def remaining_cuts(self) -> Optional[int]:
        raise NotImplementedError

    @property
    def num_cuts(self) -> Optional[int]:
        raise NotImplementedError

    # -- stepping --------------------------------------------------------------------

    def __next__(self):
        self._just_restored_state = False
        batches = self._draw_for_all_ranks()
        if not batches:
            raise StopIteration()
        if len(batches) != self.world_size:
            batches = self._rebalance_tail(batches)
        mine = batches[self.rank]
        self._log_diagnostics(mine)
        for t in self._transforms:
            mine = t(mine)
        attach_dataloading_info(mine, rank=self.rank, world_size=self.world_size)
        return mine

    def _draw_for_all_ranks(self) -> list:
        """One batch per rank; may come up short at end-of-data."""
        drawn = []
        for _ in range(self.world_size):
            try:
                drawn.append(self._next_batch())
            except StopIteration:
                if self.world_size == 1 or self.drop_last:
                    raise
        self.diagnostics.consumed(sum(len(b[0]) if isinstance(b, tuple) else len(b) for b in drawn))
        return drawn

    def _rebalance_tail(self, batches: list) -> list:
        """
        End-of-data with fewer batches than ranks: pool what's left, pad by
        duplicating the first few cuts (with marked ids), split evenly.
        Deterministic, so every rank computes the identical split.
        """
        from lhotse_tpu_torch.manipulation import combine

        pooled = combine([b for b in batches if b is not None])
        round_no = 0
        while (short := self.world_size - len(pooled)) > 0:
            clones = pooled.subset(first=short).modify_ids(mark_as_duplicate(round_no))
            pooled = pooled + clones
            round_no += 1
        return pooled.split(self.world_size)

    def _log_diagnostics(self, batch: Union[CutSet, Tuple[CutSet, ...]]) -> None:
        if isinstance(batch, CutSet):
            self.diagnostics.keep(batch)
        elif isinstance(batch, tuple) and isinstance(batch[0], CutSet):
            self.diagnostics.keep(batch[0])
        else:
            raise ValueError(f"Object with unexpected type: {batch}")

    def get_report(self) -> str:
        """Human-readable sampling statistics so far."""
        return self.diagnostics.get_report()


class SamplingConstraint(metaclass=ABCMeta):
    """Accumulates sampled examples and says when a batch is full."""

    add = abstractmethod(lambda self, example: None)
    exceeded = abstractmethod(lambda self: False)
    close_to_exceeding = abstractmethod(lambda self: False)
    reset = abstractmethod(lambda self: None)
    measure_length = abstractmethod(lambda self, example: 0.0)

    def select_bucket(self, buckets: Any, example: Any = None, example_len: Any = None) -> int:
        """Index of the first bucket whose boundary exceeds the example length."""
        if not exactly_one_not_null(example, example_len):
            raise AssertionError(
                f"select_bucket requires either example= or example_len= "
                f"(received {example=} and {example_len=})."
            )
        measured = example_len if example_len is not None else self.measure_length(example)
        return bisect_left(buckets, measured)

    def copy(self) -> "SamplingConstraint":
        return copy.copy(self)


class _PaddedBatchBudget(SamplingConstraint):
    """
    Shared engine for padded-batch budgets: subclasses name their dataclass
    fields via ``_CAP_TOTAL`` / ``_CAP_COUNT`` / ``_COUNT`` / ``_QUAD`` and
    this base prices examples, tracks the running padded cost, and answers
    ``exceeded`` / ``close_to_exceeding``.

    The core pricing rule: a batch costs ``count x longest_seen`` — the size
    of the padded tensor XLA will compile.  A quadratic term (when the QUAD
    field is set) re-prices each example as ``d + d^2/q`` for attention-bound
    models.  Setting ``_SUM_COSTS`` prices by the plain sum instead (used for
    gap-concatenated batches that waste no padding).
    """

    _CAP_TOTAL: str
    _CAP_COUNT: str
    _COUNT: str
    _QUAD: str

    def _budget(self) -> tuple:
        return (getattr(self, self._CAP_TOTAL), getattr(self, self._CAP_COUNT))

    def _validate_caps(self) -> None:
        for name in (self._CAP_TOTAL, self._CAP_COUNT, self._QUAD):
            if not is_none_or_gt(getattr(self, name), 0):
                raise AssertionError(f"{type(self).__name__}.{name} must be None or > 0")

    def _priced(self, size) -> float:
        quad = getattr(self, self._QUAD)
        return size if quad is None else size + size**2 / quad

    def add(self, example) -> None:
        if getattr(self, self._CAP_TOTAL) is not None:
            cost = self._priced(self.measure_length(example))
            self.current += cost
            self.longest_seen = max(self.longest_seen, cost)
        setattr(self, self._COUNT, getattr(self, self._COUNT) + 1)

    def _over_budget(self, hypothetical_count: int) -> bool:
        cap_total, _ = self._budget()
        if cap_total is None:
            return False
        if getattr(self, "concatenate_cuts", False):
            return self.current > cap_total
        return hypothetical_count * self.longest_seen > cap_total

    def exceeded(self) -> bool:
        _, cap_count = self._budget()
        count = getattr(self, self._COUNT)
        return (cap_count is not None and count > cap_count) or self._over_budget(count)

    def close_to_exceeding(self) -> bool:
        """Would one more longest-seen-sized example blow the budget?"""
        _, cap_count = self._budget()
        count = getattr(self, self._COUNT)
        return (cap_count is not None and count >= cap_count) or self._over_budget(count + 1)

    def reset(self) -> None:
        self.current = 0
        self.longest_seen = 0
        setattr(self, self._COUNT, 0)


def _caps_agree(mine, theirs) -> bool:
    if mine is None or theirs is None:
        return mine is theirs
    return isclose(mine, theirs)


@dataclass
class TimeConstraint(_PaddedBatchBudget):
    """
    Bounds the batch by padded duration and/or cut count.

    The duration criterion prices the batch as *padded*: cost = num_cuts x
    longest-seen duration — on TPU that product IS the compiled tensor size.
    ``quadratic_duration=q`` re-prices each cut as ``d + d^2/q`` to tame
    O(T^2) attention costs; ``concatenate_cuts`` switches to a plain sum of
    durations (for gap-concatenated batches with no padding waste).
    """

    max_duration: Optional[Seconds] = None
    max_cuts: Optional[int] = None
    current: Union[int, Seconds] = 0
    num_cuts: int = 0
    longest_seen: Union[int, float] = 0
    quadratic_duration: Optional[Seconds] = None
    concatenate_cuts: bool = False

    _CAP_TOTAL = "max_duration"
    _CAP_COUNT = "max_cuts"
    _COUNT = "num_cuts"
    _QUAD = "quadratic_duration"

    def __post_init__(self) -> None:
        self._validate_caps()

    def is_active(self) -> bool:
        return self.max_duration is not None or self.max_cuts is not None

    def measure_length(self, example: Cut) -> float:
        return example.duration

    def state_dict(self) -> Dict[str, Any]: return asdict(self)  # noqa: E704

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        drain_state(
            "TimeConstraint", state_dict, self,
            required=("max_duration", "max_cuts", "current", "num_cuts"),
            optional=(("longest_seen", 0), ("quadratic_duration", None),
                      ("concatenate_cuts", None)))

    def __add__(self, other: "TimeConstraint") -> "TimeConstraint":
        if self != other:
            diffs = ", ".join(
                f"self.{k}={getattr(self, k)} vs other.{k}={getattr(other, k)}"
                for k in ("max_duration", "max_cuts", "quadratic_duration")
                if not _caps_agree(getattr(self, k), getattr(other, k)))
            raise AssertionError(
                f"To add two TimeConstraint objects they must represent the "
                f"same constraint ({diffs})."
            )
        return TimeConstraint(
            max_duration=self.max_duration, max_cuts=self.max_cuts,
            current=self.current + other.current, num_cuts=self.num_cuts + other.num_cuts,
            longest_seen=max(self.longest_seen, other.longest_seen),
            quadratic_duration=self.quadratic_duration)

    def __eq__(self, other: "TimeConstraint") -> bool:
        return all(
            _caps_agree(getattr(self, k), getattr(other, k))
            for k in ("max_duration", "max_cuts", "quadratic_duration"))


@dataclass
class TokenConstraint(_PaddedBatchBudget):
    """
    Token-count analog of :class:`TimeConstraint` for text sampling: bounds
    the padded token total and/or example count, with an optional quadratic
    length penalty.
    """

    max_tokens: int = None
    max_examples: int = None
    current: int = 0
    num_examples: int = 0
    longest_seen: int = 0
    quadratic_length: Optional[int] = None

    _CAP_TOTAL = "max_tokens"
    _CAP_COUNT = "max_examples"
    _COUNT = "num_examples"
    _QUAD = "quadratic_length"

    def __post_init__(self) -> None:
        self._validate_caps()

    def measure_length(self, example: TextExample) -> float:
        return example.num_tokens


def _report_row(label: str, kept_c, total_c, disc_c, kept_b, total_b, disc_b) -> str:
    return (
        f"| {label} | cuts kept {kept_c:d}/{total_c:d} "
        f"({kept_c / total_c:.2%}) "
        f"| cuts discarded {disc_c:d} "
        f"| batches kept {kept_b:d}/{total_b:d} "
        f"({kept_b / total_b:.2%})"
        f"| batches discarded {disc_b:d} |"
    )


_EMPTY_REPORT = ("Sampling statistics unavailable: EpochDiagnostics received no cuts or batches.")


@dataclass
class EpochDiagnostics:
    epoch: int = 0
    kept_cuts: int = 0
    discarded_cuts: int = 0
    kept_batches: int = 0
    discarded_batches: int = 0
    # Cuts drawn from the data source into sampled batches this epoch.  With
    # world_size > 1 this exceeds kept_cuts (each step samples world_size
    # batches and keeps one) and is the correct replay fast-forward amount.
    # (The reference fast-forwards by kept+discarded, which under-skips in
    # DDP map-style resume; we count real consumption.)
    source_cuts: int = 0

    total_cuts = property(lambda self: self.kept_cuts + self.discarded_cuts)
    total_batches = property(lambda self: self.kept_batches + self.discarded_batches)

    @property
    def consumed_cuts(self) -> int:
        """Cuts pulled from the source this epoch (batched + filtered out) —
        the replay fast-forward amount.  Pre-source_cuts states fall back to
        kept + discarded."""
        if self.source_cuts == 0 and self.kept_cuts > 0:
            return self.total_cuts
        return self.source_cuts + self.discarded_cuts

    def get_report(self) -> str:
        if self.total_batches == 0 or self.total_cuts == 0:
            return _EMPTY_REPORT
        return _report_row(
            f"ep {self.epoch:>3d}", self.kept_cuts, self.total_cuts, self.discarded_cuts,
            self.kept_batches, self.total_batches, self.discarded_batches)

    def state_dict(self) -> Dict[str, Any]: return asdict(self)  # noqa: E704

    def load_state_dict(self, state_dict: Dict[str, Any]) -> "EpochDiagnostics":
        drain_state(
            "EpochDiagnostics", state_dict, self,
            required=("epoch", "kept_batches", "discarded_batches", "kept_cuts", "discarded_cuts"),
            optional=(("source_cuts", 0),))
        return self

    def __add__(self, other: "EpochDiagnostics") -> "EpochDiagnostics":
        if self.epoch != other.epoch:
            raise AssertionError(
                f"Cannot merge EpochDiagnostics of epochs {self.epoch} != {other.epoch}"
            )
        return EpochDiagnostics(
            epoch=self.epoch, kept_cuts=self.kept_cuts + other.kept_cuts,
            kept_batches=self.kept_batches + other.kept_batches,
            discarded_cuts=self.discarded_cuts + other.discarded_cuts,
            discarded_batches=self.discarded_batches + other.discarded_batches,
            source_cuts=self.source_cuts + other.source_cuts)


@dataclass
class SamplingDiagnostics:
    """Per-epoch EpochDiagnostics plus whole-run aggregates."""

    current_epoch: int = 0
    stats_per_epoch: Dict[int, EpochDiagnostics] = None

    def __post_init__(self):
        if self.stats_per_epoch is None:
            self.stats_per_epoch = {self.current_epoch: EpochDiagnostics(self.current_epoch)}

    def reset_current_epoch(self) -> None:
        self.stats_per_epoch[self.current_epoch] = EpochDiagnostics(self.current_epoch)

    def set_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch
        self.stats_per_epoch.setdefault(epoch, EpochDiagnostics(epoch=epoch))

    def advance_epoch(self) -> None:
        self.set_epoch(self.current_epoch + 1)

    @property
    def current_epoch_stats(self) -> EpochDiagnostics:
        return self.stats_per_epoch[self.current_epoch]

    def keep(self, cuts: Iterable[Cut]) -> None:
        stats = self.current_epoch_stats
        n = sum(1 for _ in cuts)
        stats.kept_cuts += n
        if n == 0:
            warnings.warn("Found and accepted batch with zero cuts. This could be an error.")
        stats.kept_batches += 1

    def consumed(self, num_cuts: int) -> None:
        """Cuts drawn from the source into sampled batches (including the
        batches other DDP ranks keep)."""
        self.current_epoch_stats.source_cuts += num_cuts

    def discard(self, cuts: Iterable[Cut]) -> None:
        stats = self.current_epoch_stats
        n = sum(1 for _ in cuts)
        stats.discarded_cuts += n
        if n:
            stats.discarded_batches += 1

    def discard_single(self, cut: Cut) -> None:
        self.current_epoch_stats.discarded_cuts += 1

    def _sum(self, field: str) -> int:
        return sum(getattr(s, field) for s in self.stats_per_epoch.values())

    kept_cuts = property(lambda self: self._sum("kept_cuts"))
    discarded_cuts = property(lambda self: self._sum("discarded_cuts"))
    kept_batches = property(lambda self: self._sum("kept_batches"))
    discarded_batches = property(lambda self: self._sum("discarded_batches"))
    total_cuts = property(lambda self: self._sum("total_cuts"))
    total_batches = property(lambda self: self._sum("total_batches"))

    def get_report(self, per_epoch: bool = False) -> str:
        if self.total_batches == 0 or self.total_cuts == 0:
            return (
                "Sampling statistics unavailable: the SamplerDiagnostics received "
                "no cuts or batches."
            )
        lines = []
        if per_epoch:
            lines += [self.stats_per_epoch[e].get_report() for e in sorted(self.stats_per_epoch)]
        lines.append(
            _report_row(
                " total ",
                self.kept_cuts, self.total_cuts, self.discarded_cuts,
                self.kept_batches, self.total_batches, self.discarded_batches,
            )
        )
        return "\n".join(lines)

    def state_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> "SamplingDiagnostics":
        self.current_epoch = state_dict.pop("current_epoch")
        self.stats_per_epoch = {
            int(epoch): EpochDiagnostics().load_state_dict(sd) for epoch,
            sd in state_dict.pop("stats_per_epoch").items()}
        return self

    def __add__(self, other: "SamplingDiagnostics") -> "SamplingDiagnostics":
        merged = deepcopy(self.stats_per_epoch)
        for epoch, stats in other.stats_per_epoch.items():
            merged[epoch] = merged[epoch] + stats if epoch in merged else stats
        return SamplingDiagnostics(current_epoch=self.current_epoch, stats_per_epoch=merged)
