"""
The library-owned data loader and the host→device stages of the input
pipeline (port of ``lhotse_tpu/dataset/loader.py``).

- :class:`DataLoader` drives ``sampler -> dataset[cuts] -> batch dict``.
  With ``num_workers=0`` a background thread prefetches batches; with
  ``num_thread_workers`` threads assemble them; with ``num_workers >= 1``
  batch assembly (audio decode, collation) fans out to spawned worker
  processes, in the ``"batch"`` or ``"partition"`` dedup mode. Workers do
  host work only and never touch the card. ``state_dict()`` is pinned to
  the batches the caller consumed, prefetch and ``checkpoint_objects``
  included.
- :func:`transfer_stream` for batches staged with
  ``OnDeviceAugmenter.stage(..., transfer=False)``, and
  :func:`device_prefetch` for plain batch trees.

The device stages keep a few batches' copies in flight ahead of the
consumer, so the copy of batch N+1 overlaps the compute on batch N. The
copy goes through pinned host memory without blocking the host; the device
kernels that read the batch are ordered after it on the current stream.
The JAX package's ``worker_jax_platform`` has no counterpart, and
``device_prefetch`` takes no ``sharding``, which belongs with a multi-device
mesh.
"""
from __future__ import annotations

import collections
import queue
import threading
import traceback
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from lhotse_tpu_torch.dataset.device_augment import _to_device


def _device_put(device, caller: str) -> Callable[[np.ndarray], torch.Tensor]:
    """A copy of a host array to ``device``: through pinned memory without
    blocking for a CUDA device, a plain copy otherwise."""
    if device is None:
        raise ValueError(f"{caller} needs a device.")
    device = torch.device(device)
    return lambda x: _to_device(x, device)


def _tree_device_put(batch, put):
    """``batch`` with every numpy leaf replaced by ``put(leaf)``; dicts,
    lists and tuples are walked, every other leaf (str, int, tensors, ...)
    passes through."""
    if isinstance(batch, np.ndarray):
        return put(batch)
    if isinstance(batch, dict):
        return {k: _tree_device_put(v, put) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_device_put(v, put) for v in batch)
    return batch


def _lookahead(items: Iterable, size: int, fn) -> Iterator:
    """Yield ``fn(item)`` for each item, with ``fn`` applied up to ``size``
    items ahead of the consumer."""
    buf = collections.deque()
    it = iter(items)
    try:
        for _ in range(max(size, 1)):
            buf.append(fn(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(fn(next(it)))
        except StopIteration:
            pass
        yield out


def _transfer_staged(item, put):
    """Copy a staged batch's numpy ``audio`` and draws with ``put``; items
    may be ``(staged, aux...)`` tuples, and anything without a numpy
    ``audio`` attribute passes through."""
    staged = item[0] if isinstance(item, tuple) else item
    if isinstance(getattr(staged, "audio", None), np.ndarray):
        staged.audio = put(staged.audio)
        staged.kwargs = _tree_device_put(staged.kwargs, put)
    return item


def transfer_stream(
    staged_batches: Iterable, lookahead: int = 2, *, device=None,
    put: Optional[Callable] = None,
) -> Iterator:
    """
    Dedicated host→device transfer stage for
    :class:`~lhotse_tpu_torch.dataset.device_augment.StagedBatch` pipelines
    built with ``OnDeviceAugmenter.stage(..., transfer=False)``: keeps up to
    ``lookahead`` batches' copies ahead of the consumer. Items may be bare
    staged batches or ``(staged, aux...)`` tuples. A staged batch's numpy
    ``audio`` and its numpy draws (``kwargs``) are copied; anything without
    a numpy ``audio`` attribute (e.g. a fully cache-resident
    :class:`~lhotse_tpu_torch.dataset.device_augment.CachedBatch`) passes
    through untouched.

    :param device: the device to copy to (pinned, non-blocking for CUDA).
    :param put: override for the copy, ``put(ndarray) -> tensor``; give
        either ``device`` or ``put``.
    """
    if put is None:
        put = _device_put(device, "transfer_stream")
    return _lookahead(staged_batches, lookahead, lambda item: _transfer_staged(item, put))


def device_prefetch(batches: Iterable, size: int = 2, *, device=None) -> Iterator:
    """
    Double-buffered host→device staging: copy up to ``size`` upcoming
    batches ahead of the consumer (numpy leaves only; str/int leaves pass
    through) so the transfer of batch N+1 overlaps the compute on batch N.

    :param device: the device to copy to (pinned, non-blocking for CUDA).
    """
    put = _device_put(device, "device_prefetch")
    return _lookahead(batches, size, lambda b: _tree_device_put(b, put))


_SENTINEL = object()


def _worker_entrypoint(
    worker_id: int, num_workers: int, rank: int, world_size: int, seed: int, dedup: str,
    sampler, dataset, apply_fn, out_q) -> None:
    """Body of one spawned assembly worker (module-level for picklability).
    Batch assembly is host work: nothing here touches the card."""
    from lhotse_tpu_torch.dataset.dataloading import (WorkerInfo, set_worker_info, worker_init_fn)

    set_worker_info(WorkerInfo(id=worker_id, num_workers=num_workers, seed=seed))
    worker_init_fn(
        worker_id, rank=rank if dedup == "partition" else None,
        world_size=world_size if dedup == "partition" else None, seed=seed)
    try:
        for batch_idx, cuts in enumerate(sampler):
            if dedup == "batch" and batch_idx % num_workers != worker_id:
                continue
            # In batch-dedup mode every worker consumes the full sampler
            # stream, so its state after drawing batch i is exactly the
            # consumed-through-i checkpoint; ship it with the batch.
            snap = None
            if dedup == "batch":
                try:
                    # deep copy: mp.Queue pickles lazily in a feeder thread,
                    # and this loop keeps mutating live state-dict internals
                    import copy as _copy

                    snap = _copy.deepcopy(sampler.state_dict())
                except (AttributeError, TypeError):
                    pass
            batch = dataset[cuts]
            if apply_fn is not None:
                batch = apply_fn(batch)
            out_q.put(("item", (snap, batch)))
    except Exception as exc:  # noqa: BLE001 — forwarded to the consumer
        out_q.put(("error", f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"))
    finally:
        out_q.put(("done", None))


class DataLoader:
    """
    Turns ``(sampler, dataset)`` into an iterator of assembled batches.

    :param sampler: an iterable of CutSet mini-batches (any CutSampler).
    :param dataset: map-style: ``dataset[cuts] -> batch`` (pytree of numpy).
    :param num_workers: 0 = single background thread; N >= 1 = N spawned
        processes assembling batches in parallel.
    :param num_thread_workers: N >= 1 = N THREADS assembling batches from
        one shared sampler (exact order preserved). No IPC/pickling;
        decode/FFT/DSP release the GIL so threads overlap on multi-core
        hosts (on a single core this measures as a net loss — keep 0
        there). Mutually exclusive with ``num_workers``.
    :param prefetch_batches: bound on in-flight assembled batches (per worker
        when ``num_workers >= 1``).
    :param apply_fn: optional post-processing applied where assembly runs
        (inside the spawned workers when ``num_workers >= 1`` — it must be
        picklable there).
    :param main_apply_fn: optional post-processing applied in the MAIN
        process to each batch as it is yielded, after ``apply_fn``. Use for
        steps that cannot cross a process boundary — e.g. device staging
        (``OnDeviceAugmenter.stage``) over process workers, typically
        followed by :func:`transfer_stream`.
    :param worker_dedup: "batch" (stride batches across workers; exact
        single-process order — requires a deterministic sampler seed) or
        "partition" (per-worker source partition via the rank/worker
        contract; use with sharded/indexed sources).
    :param seed: base seed for per-worker RNG derivation.
    :param checkpoint_objects: additional stateful pipeline stages (e.g.
        :class:`~lhotse_tpu_torch.dataset.device_augment.OnDeviceAugmenter`) whose
        ``state_dict``/``load_state_dict`` should ride along with the
        loader's. Published at YIELD time, pinned to the yielded batch: if an
        object's ``state_dict`` accepts ``after=<batch>`` (the augmenter's
        does — staged batches carry the ``aug_counter`` they were keyed by),
        the snapshot reflects exactly the batches the caller consumed, even
        while a prefetch thread stages ahead; when ``apply_fn`` stages and
        computes in the producer (the yielded batch carries no counter), the
        in-process producers snapshot the objects right after assembling
        each batch and that snapshot is published with it.
    :param transfer_lookahead: N >= 1 runs ``main_apply_fn`` and the
        host→device copy of its result up to N batches ahead of the
        consumer (for ``main_apply_fn`` staging with
        ``OnDeviceAugmenter.stage(..., transfer=False)``: the copy is
        :func:`transfer_stream`'s, of the staged numpy audio and draws,
        through pinned memory without blocking, to ``device``).
        Same overlap as wrapping the loader in :func:`transfer_stream`, with
        one crucial difference: ``state_dict()`` stays pinned to the batch
        the CONSUMER received — an external wrapper pulls the loader ahead,
        so a mid-epoch checkpoint taken through it would skip the
        in-flight transferred batches on resume.
    :param device: the device ``transfer_lookahead`` copies to; it must be
        given with ``transfer_lookahead`` and ``main_apply_fn``.
    """

    def __init__(
        self, sampler: Iterable, dataset: Any, prefetch_batches: int = 2,
        apply_fn: Optional[Callable[[Any], Any]] = None, num_workers: int = 0,
        num_thread_workers: int = 0, worker_dedup: str = "batch", seed: int = 42,
        main_apply_fn: Optional[Callable[[Any], Any]] = None,
        checkpoint_objects: Optional[list] = None,
        transfer_lookahead: int = 0, device=None):
        if worker_dedup not in ("batch", "partition"):
            raise ValueError(f"worker_dedup must be 'batch' or 'partition', got {worker_dedup!r}")
        if num_workers and num_thread_workers:
            raise ValueError(
                "num_workers (processes) and num_thread_workers are mutually "
                "exclusive assembly modes."
            )
        if num_workers >= 1 and apply_fn is not None:
            # Spawned workers receive apply_fn by pickling; failing here with
            # guidance beats the raw "Can't get local object" at start().
            import pickle

            try:
                pickle.dumps(apply_fn)
            except Exception as e:
                raise ValueError(
                    "apply_fn must be picklable when num_workers >= 1 (it "
                    f"runs inside spawned worker processes): {e}. Define it "
                    "at module level, or pass it as main_apply_fn to run it "
                    "in the main process instead (the right place for device "
                    "staging like OnDeviceAugmenter.stage)."
                ) from e
        self.sampler = sampler
        self.dataset = dataset
        self.prefetch_batches = max(int(prefetch_batches), 0)
        self.apply_fn = apply_fn
        self.num_workers = max(int(num_workers), 0)
        self.num_thread_workers = max(int(num_thread_workers), 0)
        self.worker_dedup = worker_dedup
        self.seed = seed
        self.main_apply_fn = main_apply_fn
        self.checkpoint_objects = list(checkpoint_objects or [])
        self.transfer_lookahead = max(int(transfer_lookahead), 0)
        self._put = (
            _device_put(device, "DataLoader(transfer_lookahead=...)")
            if self.transfer_lookahead and main_apply_fn is not None else None)
        self._last_object_states: Optional[list] = None

    def state_dict(self) -> Dict[str, Any]:
        """
        Checkpoint reflecting the batches actually YIELDED to the caller.
        With prefetching or thread workers the underlying sampler runs ahead
        of consumption; the in-process assembly paths therefore snapshot the
        sampler after every batch draw and this returns the snapshot of the
        last yielded batch — resuming continues exactly after it (the
        in-flight batches are re-assembled). Multiprocess batch-dedup
        workers ship their own snapshots with each batch (every worker
        consumes the full sampler stream, so its state at batch i IS the
        consumed-through-i checkpoint). Before iteration starts, or in
        partition-dedup multiprocess mode (per-partition states do not
        compose), this falls back to the live sampler state.
        """
        from lhotse_tpu_torch.checkpoint import detach_state

        state = getattr(self, "_last_yielded_state", None)
        if state is None:
            # pre-iteration fallback: detached copy for the same reason as
            # _snapshot_sampler — the returned dict must not share live
            # internals with a sampler that may start advancing afterwards
            state = detach_state(self.sampler.state_dict())
        out: Dict[str, Any] = {"sampler": state}
        if self.checkpoint_objects:
            obj_states = self._last_object_states
            if obj_states is None:
                # pre-iteration: the objects haven't staged anything yet, so
                # their live state IS the consumed-through-nothing state.
                obj_states = [
                    detach_state(obj.state_dict())
                    for obj in self.checkpoint_objects
                ]
            out["objects"] = obj_states
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        import copy

        # Samplers CONSUME their state dict (keys popped, reference parity);
        # the loader hands over a deep copy so one checkpoint object can be
        # loaded into multiple loaders (e.g. every rank reading one file).
        self.sampler.load_state_dict(copy.deepcopy(state["sampler"]))
        obj_states = state.get("objects")
        if obj_states is not None:
            if len(obj_states) != len(self.checkpoint_objects):
                raise ValueError(
                    f"Checkpoint carries {len(obj_states)} object states but "
                    f"this loader has {len(self.checkpoint_objects)} "
                    "checkpoint_objects — the pipeline composition changed."
                )
            for obj, sd in zip(self.checkpoint_objects, obj_states):
                obj.load_state_dict(copy.deepcopy(sd))
        self._last_yielded_state = None
        self._last_object_states = None

    def _capture_object_states(self, batch, produced: Optional[list]) -> None:
        """Snapshot every checkpoint object pinned to the just-yielded batch.
        Objects whose ``state_dict`` accepts ``after=`` use the batch's
        embedded counter (a batch staged by ``main_apply_fn``). Otherwise the
        snapshot the in-process producer took right after assembling this
        batch (``produced``, see :meth:`_snapshot_objects`) is exact even
        while the producer stages ahead; the live state is the fallback only
        where no producer snapshot exists (process workers)."""
        from lhotse_tpu_torch.checkpoint import detach_state

        states = []
        for i, obj in enumerate(self.checkpoint_objects):
            try:
                sd = detach_state(obj.state_dict(after=batch))
            except (TypeError, ValueError, AttributeError):
                # state_dict() without an `after` parameter, or a batch the
                # object cannot pin to (not staged by it, e.g. apply_fn staged
                # and computed in the producer).
                sd = produced[i] if produced is not None else detach_state(obj.state_dict())
            states.append(sd)
        self._last_object_states = states

    def _snapshot_objects(self) -> Optional[list]:
        """The checkpoint objects' states right after the producer assembled
        a batch (``apply_fn`` included): with ``apply_fn`` staging in the
        producer, this is the state consumed-through-that-batch. Detached,
        because the producer goes on advancing the objects."""
        if not self.checkpoint_objects:
            return None
        from lhotse_tpu_torch.checkpoint import detach_state

        return [detach_state(obj.state_dict()) for obj in self.checkpoint_objects]

    # -- single-process (threaded prefetch) ------------------------------------

    def _snapshot_sampler(self):
        """Sampler state AFTER the batch just drawn (cheap: O(tokens)).

        Detached at capture time: sampler state dicts can embed LIVE
        mutable objects (buffer lists, drained masks), and the prefetch
        thread keeps advancing the sampler after this snapshot is taken —
        without the copy, a checkpoint read later reflects whatever the
        producer got to, skipping the in-flight batches on resume."""
        from lhotse_tpu_torch.checkpoint import detach_state

        try:
            return detach_state(self.sampler.state_dict())
        except (AttributeError, TypeError, NotImplementedError):
            # plain iterables (no state_dict) and deliberately
            # non-checkpointable pipelines (e.g. infinite mux) must not
            # break ITERATION — the loud refusal happens if/when the user
            # actually asks for loader.state_dict()
            return None

    def _sampler_and_assemble(self) -> Iterator:
        """Pull (sampler -> dataset -> apply_fn) with tracing spans, so a
        stage breakdown of the input pipeline is one env var away. Yields
        ``((sampler snapshot, objects snapshot), batch)``; callers publish
        the snapshots when the batch is handed to the consumer."""
        from lhotse_tpu_torch.tracing import trace_span

        it = iter(self.sampler)
        while True:
            with trace_span("sampler.next"):
                try:
                    cuts = next(it)
                except StopIteration:
                    return
                snap = self._snapshot_sampler()
            with trace_span("dataset.assemble"):
                batch = self.dataset[cuts]
                if self.apply_fn is not None:
                    batch = self.apply_fn(batch)
            yield (snap, self._snapshot_objects()), batch

    def _produce(self, q: "queue.Queue", stop: "threading.Event") -> None:
        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for item in self._sampler_and_assemble():
                if stop.is_set() or not put(item):
                    return
        except BaseException as e:  # noqa: B036 - forwarded to the consumer
            put(e)
            return
        put(_SENTINEL)

    def _iter_threaded(self) -> Iterator:
        """Yields ``(snapshot, batch)`` pairs; publication to
        ``_last_yielded_state`` happens in :meth:`_finalize_stream` at
        consumer-yield time."""
        if self.prefetch_batches == 0:
            yield from self._sampler_and_assemble()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        worker = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Runs on exhaustion AND on generator close/GC: stop the producer
            # so an abandoned iterator cannot keep consuming (and mutating)
            # the sampler's lazy graph behind the caller's back.
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            worker.join(timeout=5.0)

    # -- multi-process assembly --------------------------------------------------

    def _iter_multiprocess(self) -> Iterator:
        import multiprocessing as mp

        from lhotse_tpu_torch.dataset.dataloading import get_rank, get_world_size

        ctx = mp.get_context("spawn")
        rank, world = get_rank(), get_world_size()
        queues = [ctx.Queue(maxsize=max(self.prefetch_batches, 1)) for _ in range(self.num_workers)]
        procs = [
            ctx.Process(
                target=_worker_entrypoint,
                args=(
                    w, self.num_workers, rank, world, self.seed,
                    self.worker_dedup, self.sampler, self.dataset, self.apply_fn, queues[w],
                ),
                daemon=True,
            )
            for w in range(self.num_workers)
        ]
        for p in procs:
            p.start()

        try:
            if self.worker_dedup == "batch":
                # Workers hold interleaved batch indices: strict round-robin
                # reconstruction yields the single-process order exactly.
                payloads = self._drain_round_robin(queues)
            else:
                payloads = self._drain_any_order(queues)
            # The checkpoint objects live in this process, not in the
            # workers: no producer snapshot of them.
            for snap, batch in payloads:
                yield (snap, None), batch
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)

    @staticmethod
    def _take(q) -> tuple:
        kind, payload = q.get()
        if kind == "error":
            raise RuntimeError(f"DataLoader worker failed:\n{payload}")
        return kind, payload

    def _drain_round_robin(self, queues) -> Iterator:
        # Batch i lives on worker i % N, and the k-th poll of a worker in the
        # rotation retrieves its k-th batch — so polling the owner of each
        # successive index reconstructs the exact single-process order.
        dead = set()
        idx = 0
        while len(dead) < self.num_workers:
            w = idx % self.num_workers
            idx += 1
            if w in dead:
                continue
            kind, payload = self._take(queues[w])
            if kind == "done":
                dead.add(w)
                continue
            yield payload

    def _drain_any_order(self, queues) -> Iterator:
        import queue as q_mod

        live = set(range(self.num_workers))
        while live:
            advanced = False
            for w in list(live):
                try:
                    kind, payload = queues[w].get(timeout=0.005)
                except q_mod.Empty:
                    continue
                if kind == "error":
                    raise RuntimeError(f"DataLoader worker failed:\n{payload}")
                if kind == "done":
                    live.discard(w)
                    continue
                advanced = True
                yield payload
            if not advanced and live:
                continue

    # -- thread-pool assembly ----------------------------------------------------

    def _iter_threadpool(self) -> Iterator:
        """
        N threads assemble batches concurrently from ONE shared sampler;
        output order is exactly the sampler's (a reorder buffer holds
        early-finished batches). Unlike process workers this pays no IPC or
        re-pickling; decode, pocketfft, and the C DSP kernels release the
        GIL, so threads genuinely overlap on multi-core hosts. On a
        single-core host measurement showed a net LOSS (switching + cache
        thrash outweigh the overlap) — prefer serial assembly there.
        """
        from lhotse_tpu_torch.tracing import trace_span

        n = self.num_thread_workers
        sampler_iter = enumerate(iter(self.sampler))
        pull_lock = threading.Lock()
        cond = threading.Condition()
        done: Dict[int, Any] = {}
        state = {"next": 0, "error": None, "active": n, "closed": False}
        max_ahead = max(self.prefetch_batches, 1) + n

        def worker():
            try:
                while True:
                    with pull_lock:
                        with trace_span("sampler.next"):
                            try:
                                seq, cuts = next(sampler_iter)
                            except StopIteration:
                                return
                            snap = self._snapshot_sampler()
                    with trace_span("dataset.assemble"):
                        batch = self.dataset[cuts]
                        if self.apply_fn is not None:
                            batch = self.apply_fn(batch)
                    obj_snap = self._snapshot_objects()
                    with cond:
                        while (
                            state["error"] is None
                            and not state["closed"]
                            and seq - state["next"] >= max_ahead
                        ):
                            cond.wait()
                        if state["error"] is not None or state["closed"]:
                            return
                        done[seq] = ((snap, obj_snap), batch)
                        cond.notify_all()
            except BaseException as e:  # noqa: B036 - forwarded to consumer
                with cond:
                    if state["error"] is None:
                        state["error"] = e
                    cond.notify_all()
            finally:
                with cond:
                    state["active"] -= 1
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True, name=f"loader-asm-{i}")
            for i in range(n)
        ]
        for t in threads:
            t.start()
        i = 0
        try:
            while True:
                with cond:
                    while (
                        i not in done
                        and state["error"] is None
                        and state["active"] > 0
                    ):
                        cond.wait()
                    if state["error"] is not None:
                        raise state["error"]
                    if i not in done:
                        return  # all workers finished, buffer drained
                    snap, batch = done.pop(i)
                    state["next"] = i + 1
                    cond.notify_all()
                yield snap, batch
                i += 1
        finally:
            with cond:
                state["closed"] = True
                cond.notify_all()

    def __iter__(self) -> Iterator:
        # Snapshot the PRISTINE sampler state before any producer starts:
        # state_dict() before the first yielded batch must describe the
        # un-consumed stream, not whatever the prefetch thread has raced to.
        if getattr(self, "_last_yielded_state", None) is None:
            self._last_yielded_state = self._snapshot_sampler()
        if self.num_workers >= 1:
            it = self._iter_multiprocess()
        elif self.num_thread_workers >= 1:
            it = self._iter_threadpool()
        else:
            it = self._iter_threaded()
        return self._finalize_stream(it)

    def _publish(self, snaps, batch) -> None:
        """Make ``state_dict()`` reflect exactly this batch — called at the
        moment the batch is handed to the consumer. ``snaps`` is the
        producer's ``(sampler snapshot, objects snapshot)``."""
        snap, produced = snaps
        if snap is not None:
            self._last_yielded_state = snap
        if self.checkpoint_objects:
            self._capture_object_states(batch, produced)

    def _finalize_stream(self, it: Iterator) -> Iterator:
        """Main-process tail of the pipeline: apply ``main_apply_fn``,
        optionally run it ``transfer_lookahead`` batches ahead of the
        consumer (keeping that many async host→device transfers in flight),
        and publish the sampler snapshot + ``checkpoint_objects`` states at
        consumer-yield time. A generator (not ``map``) so that
        closing/abandoning the loader iterator still closes the inner one —
        which is what stops the producer thread."""
        from collections import deque

        lookahead = self.transfer_lookahead if self.main_apply_fn else 0
        try:
            if lookahead <= 0:
                for snap, batch in it:
                    if self.main_apply_fn is not None:
                        batch = self.main_apply_fn(batch)
                    self._publish(snap, batch)
                    yield batch
                return
            # main_apply_fn (typically OnDeviceAugmenter.stage: pad + encode)
            # and the copy to the device run up to `lookahead` batches
            # ahead; the copies are async, so transfer of batch i+1..i+N
            # overlaps the consumer's compute on batch i. Snapshots stay
            # pinned: each buffered batch carries its own, published only
            # when yielded.
            buf: deque = deque()
            for snap, batch in it:
                buf.append((snap, _transfer_staged(self.main_apply_fn(batch), self._put)))
                if len(buf) > lookahead:
                    snap0, b0 = buf.popleft()
                    self._publish(snap0, b0)
                    yield b0
            while buf:
                snap0, b0 = buf.popleft()
                self._publish(snap0, b0)
                yield b0
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
