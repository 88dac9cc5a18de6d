"""
Host-side parallel map utilities for offline jobs (copied from
``lhotse_tpu/parallel/pool.py``): ``parallel_map`` is a streaming,
order-preserving pool map with bounded queueing; ``ParallelExecutor``
lazily constructs a per-worker callable (e.g. a model) inside each worker.

Process pools are spawned, not forked (the JAX package forks): the caller
may hold a CUDA context, which a forked child cannot use. So with
``threads=False`` the function and its arguments must pickle by reference
(a module-level function or a ``functools.partial`` of one, not a lambda).
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import queue
import threading
from functools import partial
from typing import Callable, Generator, Iterable
from uuid import uuid4


def parallel_map(
    fn: Callable, *iterables: Iterable, num_jobs: int = 1, queue_size: int = 5000,
    threads: bool = False) -> Generator:
    """
    Map ``fn`` over ``iterables`` in parallel, yielding results in order as
    they become available, with at most ``queue_size`` items in flight.

    :param fn: a picklable function (when ``threads=False``).
    :param num_jobs: number of worker processes/threads. 1 = sequential map.
    :param threads: use threads instead of spawned processes.
    """
    if num_jobs == 1:
        yield from map(fn, *iterables)
        return
    thread = SubmitterThread(
        fn, *iterables, num_jobs=num_jobs, queue_size=queue_size, threads=threads)
    thread.start()
    q = thread.queue
    while thread.is_alive() or not q.empty():
        try:
            result = q.get(block=True, timeout=0.1).result()
        except queue.Empty:
            continue
        yield result
    thread.join()


class SubmitterThread(threading.Thread):
    """Submits tasks to an executor, placing futures in a bounded queue."""

    def __init__(
        self, fn: Callable, *iterables, num_jobs: int = 1, queue_size: int = 10000,
        threads: bool = False) -> None:
        super().__init__(daemon=True)
        self.fn = fn
        self.iterables = iterables
        self.num_jobs = num_jobs
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.use_threads = threads

    def run(self) -> None:
        if self.use_threads:
            executor = concurrent.futures.ThreadPoolExecutor(self.num_jobs)
        else:
            executor = concurrent.futures.ProcessPoolExecutor(
                self.num_jobs, mp_context=multiprocessing.get_context("spawn"))
        with executor as ex:
            for args in zip(*self.iterables):
                future = ex.submit(self.fn, *args)
                self.queue.put(future, block=True)


class ParallelExecutor:
    """
    Wraps an object initializer and a pool of workers; each worker lazily
    instantiates the inner runner on first use. Useful when the runner holds
    expensive state (e.g. a model) that must be created inside the worker.

    Example::

        >>> class MyRunner:
        ...     def __init__(self):
        ...         self.model = load_model()
        ...     def __call__(self, x):
        ...         return self.model(x)
        >>> executor = ParallelExecutor(MyRunner, num_jobs=4)
        >>> for output in executor(data):
        ...     ...
    """

    _local = threading.local()
    _process_runners: dict = {}
    # Every per-thread runner cache ever created, so finished executors can
    # evict their entries from all of them (thread-locals are otherwise
    # unreachable from the evicting thread).
    _thread_caches: list = []
    _caches_lock = threading.Lock()

    def __init__(
        self, init_fn: Callable, num_jobs: int = 1, threads: bool = True, queue_size: int = 5000,
        verbose: bool = False, description: str = "Processing"):
        self.init_fn = init_fn
        self.num_jobs = num_jobs
        self.threads = threads
        self.queue_size = queue_size
        self.verbose = verbose
        self.description = description
        # Unique per executor: runners are cached per worker *and* per
        # executor, so two executors with different init_fns in one process
        # never share a runner (the token survives pickling into workers).
        self._runner_token = uuid4().hex

    def _process(self, item, **kwargs):
        if self.threads:
            cache = getattr(type(self)._local, "runners", None)
            if cache is None:
                cache = type(self)._local.runners = {}
                with type(self)._caches_lock:
                    type(self)._thread_caches.append(cache)
        else:
            cache = type(self)._process_runners
        runner = cache.get(self._runner_token)
        if runner is None:
            runner = cache[self._runner_token] = self.init_fn()
        return runner(item, **kwargs)

    def __call__(self, items: Iterable, **kwargs) -> Generator:
        # Extra kwargs are forwarded to every runner call.
        gen = parallel_map(
            partial(self._process, **kwargs) if kwargs else self._process, items,
            num_jobs=self.num_jobs, queue_size=self.queue_size, threads=self.threads)
        if self.verbose:
            from tqdm.auto import tqdm

            gen = tqdm(gen, desc=self.description)
        try:
            yield from gen
        finally:
            # Evict this executor's runners (often whole models) from every
            # cache once iteration ends — otherwise per-chunk executor
            # construction pins them in the process forever.
            self._evict_runners()

    def _evict_runners(self) -> None:
        type(self)._process_runners.pop(self._runner_token, None)
        with type(self)._caches_lock:
            for cache in type(self)._thread_caches:
                cache.pop(self._runner_token, None)
