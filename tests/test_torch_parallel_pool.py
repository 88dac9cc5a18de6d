"""
The port's pool map (``lhotse_tpu_torch/parallel/pool.py``) beside the JAX
package's (``lhotse_tpu/parallel/pool.py``): every case of
``tests/test_parallel_pool.py`` runs through both packages, and the port's
process pools are shown to spawn (the JAX package forks) and to keep the
input order.
"""
import concurrent.futures
import operator

import pytest

from lhotse_tpu.parallel import pool as jpool
from lhotse_tpu_torch.parallel import pool as ppool

POOLS = {"jax": jpool, "port": ppool}


class _CountingRunner:
    instances = 0

    def __init__(self):
        type(self).instances += 1

    def __call__(self, x):
        return x * 2


@pytest.mark.parametrize("package", sorted(POOLS))
def test_ordered_streaming(package):
    assert list(
        POOLS[package].parallel_map(lambda x: x + 1, range(50), num_jobs=4, threads=True)
    ) == list(range(1, 51))


@pytest.mark.parametrize("package", sorted(POOLS))
def test_threads_mode_results(package):
    ex = POOLS[package].ParallelExecutor(_CountingRunner, num_jobs=2, threads=True)
    assert sorted(ex(range(10))) == [x * 2 for x in range(10)]


@pytest.mark.parametrize("package", sorted(POOLS))
def test_runner_cache_evicted_after_iteration(package):
    executor_cls = POOLS[package].ParallelExecutor
    ex = executor_cls(_CountingRunner, num_jobs=2, threads=True)
    list(ex(range(8)))
    token = ex._runner_token
    assert token not in executor_cls._process_runners
    for cache in executor_cls._thread_caches:
        assert token not in cache


@pytest.mark.parametrize("package", sorted(POOLS))
def test_runner_cache_evicted_on_abandoned_generator(package):
    executor_cls = POOLS[package].ParallelExecutor
    ex = executor_cls(_CountingRunner, num_jobs=1, threads=True)
    gen = ex(range(100))
    next(gen)
    gen.close()
    token = ex._runner_token
    for cache in executor_cls._thread_caches:
        assert token not in cache


@pytest.mark.parametrize("package", sorted(POOLS))
def test_distinct_executors_do_not_share_runners(package):
    executor_cls = POOLS[package].ParallelExecutor
    before = _CountingRunner.instances
    ex1 = executor_cls(_CountingRunner, num_jobs=1, threads=True)
    list(ex1(range(3)))
    ex2 = executor_cls(_CountingRunner, num_jobs=1, threads=True)
    list(ex2(range(3)))
    assert _CountingRunner.instances >= before + 2


def test_process_pool_spawns_and_keeps_order(monkeypatch):
    """Two spawned processes map a function that pickles by reference; the
    results come back in the input order, equal to the JAX package's."""
    methods = []

    class Recording(concurrent.futures.ProcessPoolExecutor):
        def __init__(self, *args, mp_context=None, **kwargs):
            methods.append(mp_context.get_start_method() if mp_context else None)
            super().__init__(*args, mp_context=mp_context, **kwargs)

    monkeypatch.setattr(ppool.concurrent.futures, "ProcessPoolExecutor", Recording)
    ours = list(ppool.parallel_map(operator.mul, range(40), range(40, 80), num_jobs=2))
    monkeypatch.undo()
    assert methods == ["spawn"]
    assert ours == list(jpool.parallel_map(operator.mul, range(40), range(40, 80), num_jobs=1))
    assert ours == [a * b for a, b in zip(range(40), range(40, 80))]
