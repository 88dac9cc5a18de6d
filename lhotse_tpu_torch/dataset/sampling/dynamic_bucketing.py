"""
Duration-bucketed streaming sampling (copied from
``lhotse_tpu/dataset/sampling/dynamic_bucketing.py``).

``DynamicBucketingSampler`` batches cuts of similar length together while
reading its input exactly once and holding at most ``buffer_size`` cuts in
memory:

* :func:`estimate_duration_buckets` picks K-1 boundary durations so each
  of the K buckets carries about the same total size;
* :class:`_BucketBuffer` holds the streamed-in cuts in one deque per bin;
* :class:`_StickyBinChooser` is the rank-synchronized bucket picker, a
  dedicated RNG seeded identically on every DDP rank and reused
  ``world_size`` times per draw;
* :class:`DynamicBucketer` refills the buffer, picks a bin and carves one
  batch out of it per step.

With ``FixedBucketBatchSizeConstraint`` the duration bins double as the
shape vocabulary of the device augmenter: every batch drawn from bucket
*i* pads to that bucket's upper bound.
"""
import random
import threading
import time
import warnings
from collections import deque
from dataclasses import asdict, dataclass
from itertools import islice
from typing import (Any, Callable, Dict, Generator, Iterable, List, Optional, Tuple, Union)

import numpy as np

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.dataset.dataloading import resolve_seed
from lhotse_tpu_torch.dataset.sampling.base import (
    CutSampler, SamplingConstraint, SamplingDiagnostics, TimeConstraint)
from lhotse_tpu_torch.dataset.sampling.checkpoint_backends import plan_resume
from lhotse_tpu_torch.dataset.sampling.dynamic import (DurationBatcher, Filter, check_constraint)
from lhotse_tpu_torch.lazy import (
    IteratorNode, require_graph_origin, resolve_iterator_source, supports_graph_restore)
from lhotse_tpu_torch.utils import Seconds, ifnone


def estimate_duration_buckets(
    cuts: Iterable[Cut], num_buckets: int, constraint: Optional[SamplingConstraint] = None,
) -> List[float]:
    """
    Choose UP TO ``num_buckets - 1`` ascending boundary lengths so that each
    bucket receives roughly the same total size mass.  Bucket ``i`` covers
    lengths in ``[bins[i-1], bins[i])``; the first starts at 0, the last is
    open.  Like the reference, skewed length distributions can yield FEWER
    than ``num_buckets - 1`` boundaries (the greedy pass only emits one when
    the running mass overflows) — size per-bucket configs from ``len(bins)``,
    not from ``num_buckets``.
    """
    if num_buckets <= 1:
        raise AssertionError("estimate_duration_buckets needs num_buckets > 1")
    measure = (constraint or TimeConstraint()).measure_length
    sizes = np.sort(np.fromiter((measure(c) for c in cuts), dtype=np.float64))
    if num_buckets > sizes.size:
        raise AssertionError(
            f"The number of buckets ({num_buckets}) must be smaller than "
            f"or equal to the number of cuts ({sizes.size})."
        )
    # Greedy equal-mass pass over the sorted sizes, emitting a boundary each
    # time the running mass exceeds total/num_buckets — matched EXACTLY to the
    # reference (dynamic_bucketing.py:495-536, including its quirk of
    # returning fewer than num_buckets-1 bins when the tail never overflows),
    # because bin boundaries decide bucket membership and therefore batch
    # composition for seeded runs.
    size_per_bucket = sizes.sum() / num_buckets
    bins: List[float] = []
    tot = 0.0
    for size in sizes:
        if tot > size_per_bucket:
            bins.append(float(size))
            tot = 0.0
        tot += float(size)
    return bins


class _BucketBuffer:
    """Streamed cuts parked in per-duration-bin deques (one shared lock)."""

    def __init__(self, num_bins: int) -> None:
        self._rows: List[deque] = [deque() for _ in range(num_bins)]
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._rows)

    def push(self, bin_idx: int, item) -> None:
        with self._lock:
            self._rows[bin_idx].append(item)

    def depth(self, bin_idx: int) -> int:
        return len(self._rows[bin_idx])

    def fill_level(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._rows)

    def peek_all(self, bin_idx: int) -> list:
        with self._lock:
            return list(self._rows[bin_idx])

    def discard(self, bin_idx: int, positions: List[int]) -> None:
        """Remove the items at ``positions`` (any order) from one bin."""
        with self._lock:
            row = self._rows[bin_idx]
            for p in sorted(positions, reverse=True):
                del row[p]

    def drop_front(self, bin_idx: int, count: int) -> None:
        with self._lock:
            row = self._rows[bin_idx]
            for _ in range(count):
                row.popleft()

    def replace_all(self, contents: List[list]) -> None:
        with self._lock:
            if len(contents) != len(self._rows):
                raise RuntimeError(
                    f"Bucket-count mismatch while restoring a checkpoint: "
                    f"saved {len(contents)}, configured {len(self._rows)}."
                )
            self._rows = [deque(items) for items in contents]


class _StickyBinChooser:
    """
    Draws a bin index from a dedicated RNG, reusing each draw ``world_size``
    times.  Map-style DDP sampling pulls ``world_size`` batches per training
    step — every rank must see the same sequence of draws, and each draw must
    cover one full step, or ranks drift onto different-duration bins.
    """

    def __init__(self, rng: random.Random, num_bins: int, world_size: int) -> None:
        self.rng = rng
        self.num_bins = num_bins
        self.reuse = world_size
        self._left = 0
        self._choice: Optional[int] = None

    def next_index(self) -> int:
        if self._left <= 0:
            self._choice = self.rng.randrange(self.num_bins)
            self._left = self.reuse
        self._left -= 1
        return self._choice

    def save(self) -> Dict[str, Any]:
        return {"rng": self.rng.getstate(), "choice": self._choice, "left": self._left}

    def restore(self, snap: Dict[str, Any]) -> None:
        self.rng.setstate(snap["rng"])
        self._choice = snap["choice"]
        self._left = snap["left"]


class _DrainedBuffers(Exception):
    """Raised internally when no bin can satisfy the current predicate."""


def pick_at_random(bucket, rng, out_indexes_used: list):
    """Yield the items of ``bucket`` (a ``queue.Queue`` or sequence) in a
    random order, recording each yielded index in ``out_indexes_used``."""
    if hasattr(bucket, "mutex"):
        with bucket.mutex:
            bucket = list(bucket.queue)
    else:
        bucket = list(bucket)
    indexes = list(range(len(bucket)))
    rng.shuffle(indexes)
    for idx in indexes:
        out_indexes_used.append(idx)
        yield bucket[idx]


class DynamicBucketer:
    """
    Pulls cuts from a stream into duration bins and emits one batch per step.

    Not a public entry point — :class:`DynamicBucketingSampler` builds one
    per epoch.  ``get_state``/``set_state`` round-trip the buffered cuts as
    graph-origin tokens plus both RNG states, which is what makes sampler
    checkpoints O(1) to restore on indexed sources.
    """

    def __init__(
        self, cuts: Iterable[Union[Cut, Tuple[Cut]]], duration_bins: List[Seconds], world_size: int,
        max_duration: Optional[Seconds] = None, max_cuts: Optional[int] = None,
        constraint: Optional[SamplingConstraint] = None, drop_last: bool = False,
        buffer_size: int = 10000, quadratic_duration: Optional[Seconds] = None,
        shuffle: bool = False, rng: random.Random = None, bucket_rng: random.Random = None,
        concurrent: bool = False, diagnostics: Optional[SamplingDiagnostics] = None,
        restore_sources: Optional[List[Iterable]] = None) -> None:
        if list(duration_bins) != sorted(duration_bins):
            raise AssertionError(
                f"Argument list for 'duration_bins' is expected to be in "
                f"sorted order (got: {duration_bins})."
            )
        check_constraint(constraint, max_duration, max_cuts)
        self.cuts = cuts
        self.restore_sources = restore_sources
        self.duration_bins = duration_bins
        self.world_size = world_size
        self.drop_last = drop_last
        self.buffer_size = buffer_size
        self.shuffle = shuffle
        self.concurrent = concurrent
        self.diagnostics = ifnone(diagnostics, SamplingDiagnostics())
        self.rng = rng if rng is not None else random.Random()
        self.bucket_rng = bucket_rng
        self.constraint = constraint or TimeConstraint(
            max_duration=max_duration, max_cuts=max_cuts, quadratic_duration=quadratic_duration)
        self._warn_if_buffer_undersized(max_duration, duration_bins, buffer_size)

        self.buffer = _BucketBuffer(len(duration_bins) + 1)
        self._feeder_thread: Optional[threading.Thread] = None
        self._stream_dry = False
        self._pending_restore: Optional[Dict[str, Any]] = None
        self._selection_state: Optional[_StickyBinChooser] = None

    @staticmethod
    def _warn_if_buffer_undersized(max_duration, duration_bins, buffer_size) -> None:
        if max_duration is None or not duration_bins:
            return
        per_bucket_sec = (buffer_size * float(np.mean(duration_bins)) / (len(duration_bins) + 1))
        if per_bucket_sec < max_duration:
            warnings.warn(
                f"Your 'buffer_size' setting of {buffer_size} might be too low "
                f"to satisfy a 'max_duration' of {max_duration} (given our "
                f"best guess)."
            )

    # -- checkpoint payload ----------------------------------------------------

    def _token_for(self, cut: Cut, source) -> Any:
        if source is None or not supports_graph_restore(source):
            raise RuntimeError(
                "DynamicBucketer checkpoint requires graph-restorable sources "
                "when saving buffered O(1) restore state."
            )
        return require_graph_origin(cut, "DynamicBucketer checkpoint", "buffered items")

    def _cut_for(self, token: Any, source) -> Cut:
        if source is None or not supports_graph_restore(source):
            raise RuntimeError(
                "This checkpoint stores graph-origin tokens, but the current "
                "iterator graph cannot fetch items by token (no constant-time "
                "access)."
            )
        return source[token]

    def _source_at(self, idx: int):
        if self.restore_sources is None:
            return None
        return self.restore_sources[idx]

    def get_state(self) -> Dict[str, Any]:
        """Bucket contents (graph tokens) + main RNG + bin-chooser state."""
        from lhotse_tpu_torch.checkpoint import _rng_state_to_json

        rows = []
        for b in range(len(self.buffer)):
            row = []
            for item in self.buffer.peek_all(b):
                members = item if isinstance(item, tuple) else (item,)
                row.append([self._token_for(c, self._source_at(k)) for k, c in enumerate(members)])
            rows.append(row)
        payload = {"bucket_tokens": rows, "rng_state": _rng_state_to_json(self.rng.getstate())}
        if self._selection_state is not None:
            payload["selection_state"] = self._selection_state.save()
        return payload

    def set_state(self, payload: Dict[str, Any]) -> None:
        """Queue a restore; applied when iteration next begins."""
        self._pending_restore = payload

    def _apply_pending_restore(self) -> _StickyBinChooser:
        from lhotse_tpu_torch.checkpoint import _rng_state_from_json

        payload, self._pending_restore = self._pending_restore, None
        self.rng.setstate(_rng_state_from_json(payload["rng_state"]))
        contents = []
        for row in payload["bucket_tokens"]:
            # zip(*sources) upstream always yields tuples; keep that shape.
            contents.append(
                [
                    tuple(
                        self._cut_for(tok, self._source_at(k))
                        for k, tok in enumerate(member_tokens)
                    )
                    for member_tokens in row
                ]
            )
        self.buffer.replace_all(contents)
        chooser = _StickyBinChooser(self.bucket_rng, len(self.buffer), self.world_size)
        if "selection_state" in payload:
            chooser.restore(payload["selection_state"])
        return chooser

    # -- streaming in -------------------------------------------------------------

    def _bin_of(self, item) -> int:
        head = item[0] if isinstance(item, tuple) else item
        return self.constraint.select_bucket(buckets=self.duration_bins, example=head)

    def _pull_into_buffer(self, count: int) -> None:
        """Move up to ``count`` items from the stream into their bins."""
        for _ in range(count):
            try:
                item = next(self.cuts_iter)
            except StopIteration:
                self._stream_dry = True
                return
            self.buffer.push(self._bin_of(item), item)

    def _spawn_feeder(self) -> None:
        """Background buffer filler (opt-in; trades determinism for latency)."""

        def feed():
            try:
                while not self._stream_dry:
                    if self.buffer.fill_level() >= self.buffer_size:
                        time.sleep(0.1)
                        continue
                    item = next(self.cuts_iter)
                    self.buffer.push(self._bin_of(item), item)
            except StopIteration:
                self._stream_dry = True

        self._feeder_thread = threading.Thread(target=feed, daemon=True)
        self._feeder_thread.start()

    def _await_feeder(self) -> None:
        """Let the feeder reach 10% buffer utilization before sampling."""
        while self.buffer.fill_level() < self.buffer_size / 10 and not self._stream_dry:
            time.sleep(1.0)

    def _stop_feeder(self) -> None:
        if self._feeder_thread is not None and self._feeder_thread.is_alive():
            self._stream_dry = True
            self._feeder_thread.join()
        self._feeder_thread = None

    # -- bin choice -------------------------------------------------------------------

    def _bin_holds_full_batch(self, bin_idx: int) -> bool:
        probe = self.constraint.copy()
        probe.reset()
        for item in self.buffer.peek_all(bin_idx):
            probe.add(item[0] if isinstance(item, tuple) else item)
            if probe.close_to_exceeding():
                return True
        return False

    def _choose_bin(self) -> int:
        if self.bucket_rng is None:
            # Local mode: any bin holding a full batch, from the shared RNG.
            full = [b for b in range(len(self.buffer)) if self._bin_holds_full_batch(b)]
            if not full:
                leftovers = [b for b in range(len(self.buffer)) if self.buffer.depth(b)]
                if self.drop_last or not leftovers:
                    raise _DrainedBuffers()
                full = leftovers
            return self.rng.choice(full)

        # Synced mode. If the drawn bin can't fill a batch, scan outward
        # (c, c-1, c+1, c-2, ...) — deterministic per rank, and the chooser
        # snapshot ensures the shared RNG advances identically on all ranks
        # even when we retry with the weaker "non-empty" predicate.
        mark = self._selection_state.save()
        try:
            return self._zigzag(self._bin_holds_full_batch)
        except _DrainedBuffers:
            if self.drop_last:
                raise
            self._selection_state.restore(mark)
            return self._zigzag(lambda b: self.buffer.depth(b) > 0)

    def _zigzag(self, acceptable: Callable[[int], bool]) -> int:
        center = self._selection_state.next_index()
        n = len(self.buffer)
        for distance in range(n + 1):
            for candidate in dict.fromkeys((center - distance, center + distance)):
                if 0 <= candidate < n and acceptable(candidate):
                    return candidate
        raise _DrainedBuffers()

    # -- batching -------------------------------------------------------------------------

    def _carve_batch(self, bin_idx: int):
        """Assemble one batch from a bin and remove exactly those items."""
        items = self.buffer.peek_all(bin_idx)
        order = list(range(len(items)))
        if self.shuffle:
            self.rng.shuffle(order)
        taken: List[int] = []

        def feed():
            for pos in order:
                taken.append(pos)
                yield items[pos]

        batcher = DurationBatcher(
            feed(), constraint=self.constraint.copy(), diagnostics=self.diagnostics)
        batch = next(iter(batcher))
        # Commit before yielding so a checkpoint taken between batches never
        # double-counts these items.
        if self.shuffle:
            self.buffer.discard(bin_idx, taken)
        else:
            size = len(batch[0]) if isinstance(batch, tuple) else len(batch)
            self.buffer.drop_front(bin_idx, size)
        size = len(batch[0]) if isinstance(batch, tuple) else len(batch)
        return batch, size

    def __iter__(self) -> Generator[CutSet, None, None]:
        self.cuts_iter = iter(self.cuts)
        if self._pending_restore is not None:
            self._selection_state = self._apply_pending_restore()
        else:
            if self.concurrent:
                self._stream_dry = False
                self._spawn_feeder()
                self._await_feeder()
            else:
                self._pull_into_buffer(self.buffer_size)
            self._selection_state = _StickyBinChooser(
                self.bucket_rng, len(self.buffer), self.world_size)
        try:
            while True:
                try:
                    bin_idx = self._choose_bin()
                except _DrainedBuffers:
                    return
                try:
                    batch, size = self._carve_batch(bin_idx)
                except StopIteration:
                    return
                if self.concurrent:
                    self._await_feeder()
                else:
                    self._pull_into_buffer(size)
                yield batch
        finally:
            if self.concurrent:
                self._stop_feeder()
            self.cuts_iter = None

    def __del__(self):
        if self.concurrent:
            self._stop_feeder()


class DynamicBucketingSampler(CutSampler):
    """
    Bounded-memory bucketing over lazy CutSets (single or zipped tuples)::

        >>> sampler = DynamicBucketingSampler(cuts, max_duration=100)
        >>> for batch in sampler: assert isinstance(batch, CutSet)

    Unlike :class:`~lhotse_tpu_torch.dataset.sampling.bucketing.BucketingSampler`,
    it never materializes the input, so it works on arbitrarily large
    corpora; bin boundaries are estimated from the first
    ``num_cuts_for_bins_estimate`` cuts unless given explicitly.
    """

    def __init__(
        self, *cuts: Iterable, max_duration: Optional[Seconds] = None,
        max_cuts: Optional[int] = None, constraint: Optional[SamplingConstraint] = None,
        num_buckets: Optional[int] = 10, shuffle: bool = False, drop_last: bool = False,
        consistent_ids: bool = True, duration_bins: List[Seconds] = None,
        num_cuts_for_bins_estimate: int = 10000, buffer_size: int = 20000,
        quadratic_duration: Optional[Seconds] = None, world_size: Optional[int] = None,
        rank: Optional[int] = None, seed: Union[int, str] = 0, sync_buckets: bool = True,
        concurrent: bool = False, strict=None, shuffle_buffer_size=None) -> None:
        super().__init__(drop_last=drop_last, world_size=world_size, rank=rank, seed=seed)
        if strict is not None:
            warnings.warn(
                "All samplers act as if 'strict=True'; the 'strict' argument is "
                "accepted for backward compatibility only and will be removed.",
                DeprecationWarning)
        if shuffle_buffer_size is not None:
            warnings.warn(
                "'shuffle_buffer_size' is deprecated: DynamicBucketingSampler does "
                "not need a separate shuffling buffer. Increasing 'buffer_size' by "
                "'shuffle_buffer_size' for backward compatibility.",
                DeprecationWarning)
            buffer_size += shuffle_buffer_size
        if not all(cs.is_lazy for cs in cuts if isinstance(cs, CutSet)):
            warnings.warn(
                "You are using DynamicBucketingSampler with an eagerly read CutSet. "
                "You won't see any memory/speed benefits with that setup. "
                "Either use 'CutSet.from_jsonl_lazy' to read the CutSet lazily, or "
                "use a BucketingSampler instead."
            )
        self.cuts = cuts
        self.max_duration, self.max_cuts = max_duration, max_cuts
        self.constraint = constraint
        self.shuffle, self.consistent_ids = shuffle, consistent_ids
        self.num_cuts_for_bins_estimate = num_cuts_for_bins_estimate
        self.buffer_size = buffer_size
        self.quadratic_duration = quadratic_duration
        self.sync_buckets, self.concurrent = sync_buckets, concurrent
        self.rng = None
        check_constraint(constraint, max_duration, max_cuts)
        self.duration_bins = self._settle_bins(duration_bins, num_buckets)
        self.num_buckets = len(self.duration_bins) + 1

    def _settle_bins(self, duration_bins, num_buckets) -> List[Seconds]:
        if duration_bins is not None:
            if list(duration_bins) != sorted(duration_bins):
                raise AssertionError("Duration bins must be sorted ascendingly.")
            return duration_bins
        probe_constraint = self.constraint or TimeConstraint(
            max_duration=self.max_duration, max_cuts=self.max_cuts,
            quadratic_duration=self.quadratic_duration)
        return estimate_duration_buckets(
            islice(self.cuts[0], self.num_cuts_for_bins_estimate), num_buckets=num_buckets,
            constraint=probe_constraint)

    # -- checkpointing ------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        sd = super().state_dict()
        sd.update(
            max_duration=self.max_duration, max_cuts=self.max_cuts,
            consistent_ids=self.consistent_ids, buffer_size=self.buffer_size,
            num_cuts_for_bins_estimate=self.num_cuts_for_bins_estimate,
            quadratic_duration=self.quadratic_duration)
        payload = self._o1_payload()
        if payload is not None:
            sd["rng_state"], sd["bucketer_state"] = payload
        return sd

    def _o1_payload(self) -> Optional[Tuple[Any, Any]]:
        """The (rng, bucketer) state pair enabling O(1) restore, if capturable."""
        bucketer = getattr(self, "_bucketer", None)
        if (
            bucketer is not None
            and self.rng is not None
            and getattr(bucketer, "_selection_state", None) is not None
        ):
            try:
                return self.rng.getstate(), bucketer.get_state()
            except RuntimeError:
                # A partially-restorable graph means a wiring bug: surface it
                # instead of silently degrading to O(N) replay.
                if any(_leaf_constant_time_flags(self.cuts)):
                    raise
            except (AttributeError, TypeError):
                pass
        # Not iterating yet: pass through any deferred payload from
        # load_state_dict so state_dict() round-trips before __iter__.
        held_rng = getattr(self, "_rng_state", None)
        held_bucketer = getattr(self, "_bucketer_state", None)
        if held_rng is not None and held_bucketer is not None:
            return held_rng, held_bucketer
        return None

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.max_duration = sd.pop("max_duration")
        self.max_cuts = sd.pop("max_cuts")
        self.consistent_ids = sd.pop("consistent_ids")
        self.num_cuts_for_bins_estimate = sd.pop("num_cuts_for_bins_estimate")
        self.buffer_size = sd.pop("buffer_size")
        self.quadratic_duration = sd.pop("quadratic_duration", None)
        self._rng_state = sd.pop("rng_state", None)
        self._bucketer_state = sd.pop("bucketer_state", None)
        super().load_state_dict(sd)
        # Restore happens inside __iter__, keeping the sampler picklable for
        # multiprocess dataloading in between.
        self._needs_fast_forward = True

    def _fast_forward(self):
        epoch = self.diagnostics.current_epoch
        steps = self.diagnostics.current_epoch_stats.total_batches
        self.set_epoch(epoch)
        plan_resume(self, "bucketing", epoch=epoch, steps_done=steps).run()

    def _initialize_replay_iterator(self) -> None:
        self._cuts_state = None
        self._rng_state = None
        self._bucketer_state = None
        self._just_restored_state = False
        iter(self)

    def _replay_step(self) -> None:
        next(self)

    # -- epoch iteration -----------------------------------------------------------

    def _bucket_selection_rng(self) -> Optional[random.Random]:
        if not self.sync_buckets:
            return None
        # Identical seed on all ranks (offset per dataloading worker) keeps
        # every rank's bin draws in lockstep.
        from lhotse_tpu_torch.dataset.dataloading import get_worker_info

        base = 1234
        worker_info = get_worker_info()
        if worker_info is not None:
            base += worker_info.id
        return random.Random(base)

    def __iter__(self) -> "DynamicBucketingSampler":
        if getattr(self, "_needs_fast_forward", False):
            self._needs_fast_forward = False
            self._fast_forward()
            return self
        if self._just_restored_state:
            return self
        self.rng = random.Random(resolve_seed(self.seed) + self.epoch)
        if getattr(self, "_skip_diagnostics_reset_once", False):
            # Restoring mid-epoch: the stats already reflect consumed batches.
            self._skip_diagnostics_reset_once = False
        else:
            self.diagnostics.reset_current_epoch()
        sources = [resolve_iterator_source(cs) for cs in self.cuts]
        joined = Filter(
            iterator=zip(*(iter(src) for src in sources)),
            predicate=lambda tpl: all(self._filter_fn(c) for c in tpl),
            diagnostics=self.diagnostics)
        self._bucketer = DynamicBucketer(
            joined, duration_bins=self.duration_bins, world_size=self.world_size,
            max_duration=self.max_duration, max_cuts=self.max_cuts, constraint=self.constraint,
            drop_last=self.drop_last, buffer_size=self.buffer_size,
            quadratic_duration=self.quadratic_duration, shuffle=self.shuffle, rng=self.rng,
            bucket_rng=self._bucket_selection_rng(), concurrent=self.concurrent,
            diagnostics=self.diagnostics, restore_sources=sources)
        self.cuts_iter = iter(self._bucketer)
        return self

    def _next_batch(self) -> Union[CutSet, Tuple[CutSet]]:
        batch = next(self.cuts_iter)
        if self.consistent_ids and isinstance(batch, tuple):
            for group in zip(*batch):
                lead = group[0].id
                if any(c.id != lead for c in group[1:]):
                    raise AssertionError(
                        f"The input CutSets are not sorted by cut ID in the same "
                        f"way. We sampled the following mismatched cut IDs: "
                        f"{', '.join(c.id for c in group)}. If this is expected, "
                        f"pass 'consistent_ids=False'."
                    )
        return batch

    # Streaming sampler: the remaining-data introspection API has no answer
    # before the epoch ends, mirroring the reference behavior.
    remaining_duration = property(lambda self: None)
    remaining_cuts = property(lambda self: None)
    num_cuts = property(lambda self: None)


@dataclass
class FixedBucketBatchSizeConstraint(SamplingConstraint):
    """
    Static per-bucket batch sizes: an example's length picks its bucket, and
    that bucket's preset batch size caps the batch.  The most
    compiler-friendly constraint on TPU — each bucket yields one fixed
    (batch, length) shape, so XLA compiles exactly one program per bucket.
    Examples longer than the last boundary are rejected.
    """

    max_seq_len_buckets: List[float]
    batch_sizes: List[int]
    current_bucket: Union[int, None] = None
    num_cuts: int = 0

    def __post_init__(self):
        if sorted(self.max_seq_len_buckets) != list(self.max_seq_len_buckets):
            raise AssertionError(f"max_seq_len_buckets must be sorted: {self.max_seq_len_buckets}")

    def is_active(self) -> bool:
        return True

    def add(self, example: Cut) -> None:
        length = self.measure_length(example)
        idx = self.select_bucket(buckets=self.max_seq_len_buckets, example_len=length)
        if idx >= len(self.max_seq_len_buckets):
            raise AssertionError(
                f"Received example with sequence length {length} that exceeds "
                f"the highest allowed length {self.max_seq_len_buckets[-1]}."
            )
        if self.current_bucket is None:
            self.current_bucket = idx
        elif self.current_bucket != idx:
            raise AssertionError(
                f"User error: FixedBucketBatchSizeConstraint is supposed to be "
                f"used only on one bucket. The example we received has sequence "
                f"length {length} which is outside of the allowed bounds for "
                f"bucket index {idx} in buckets {self.max_seq_len_buckets}."
            )
        self.num_cuts += 1

    def exceeded(self) -> bool:
        return self.num_cuts > self.batch_sizes[self.current_bucket]

    def close_to_exceeding(self) -> bool:
        return self.num_cuts >= self.batch_sizes[self.current_bucket]

    def reset(self) -> None:
        self.current_bucket = None
        self.num_cuts = 0

    def measure_length(self, example: Cut) -> float:
        return example.duration

    def state_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        for field_name in ("max_seq_len_buckets", "batch_sizes", "current_bucket", "num_cuts"):
            setattr(self, field_name, state_dict.pop(field_name))
        if state_dict:
            raise AssertionError(
                "Error in FixedBucketBatchSizeConstraint.load_state_dict(): "
                "Unexpected keys:\n- " + "\n- ".join(state_dict.keys())
            )

    def __add__(self, other: "FixedBucketBatchSizeConstraint") -> "FixedBucketBatchSizeConstraint":
        for key in ("max_seq_len_buckets", "batch_sizes", "current_bucket"):
            mine, theirs = getattr(self, key), getattr(other, key)
            if not (mine is None and theirs is None) and mine != theirs:
                raise AssertionError(
                    f"To add two FixedBucketBatchSizeConstraint objects, they "
                    f"need to represent the same constraint "
                    f"(got self.{key}={mine} != other.{key}={theirs})."
                )
        return FixedBucketBatchSizeConstraint(
            max_seq_len_buckets=self.max_seq_len_buckets, batch_sizes=self.batch_sizes,
            current_bucket=self.current_bucket, num_cuts=self.num_cuts + other.num_cuts)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, FixedBucketBatchSizeConstraint)
            and self.max_seq_len_buckets == other.max_seq_len_buckets
            and self.batch_sizes == other.batch_sizes
            and self.current_bucket == other.current_bucket
        )


def _leaf_constant_time_flags(cuts) -> List[bool]:
    """``has_constant_time_access`` of every leaf source under ``cuts``."""
    flags: List[bool] = []

    def visit(node):
        if hasattr(node, "data") and not callable(getattr(node, "data")):
            node = node.data
        kids = None
        if isinstance(node, IteratorNode):
            multi = getattr(node, "sources", None)
            if isinstance(multi, (list, tuple)) and multi:
                kids = list(multi)
            else:
                single = getattr(node, "source", None)
                if single is not None and not callable(single):
                    kids = [single]
        if kids:
            for k in kids:
                visit(k)
        else:
            flags.append(bool(getattr(node, "has_constant_time_access", False)))

    for cs in cuts:
        visit(cs)
    return flags
