"""
Manifest combination (copied from ``lhotse_tpu/manipulation.py``): the
``combine`` the samplers use to pool their last batches across ranks, and
``split_parallelize_combine``, which fans a CutSet operation out over
worker processes.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from functools import reduce
from operator import add
from typing import Callable, Iterable, TypeVar, Union

Manifest = TypeVar("Manifest")


def combine(*manifests: Union[Manifest, Iterable[Manifest]]) -> Manifest:
    """Combine multiple manifests of the same type into one (accepts varargs
    or a single list/tuple)."""
    parts = manifests[0] if len(manifests) == 1 else manifests
    return reduce(add, parts)


def split_parallelize_combine(
    num_jobs: int, manifest: Manifest, fn: Callable, *args, **kwargs) -> Manifest:
    """
    Split the manifest into ``num_jobs`` pieces, apply ``fn`` to each split in
    pool of spawned processes, and combine the results.
    """
    with ProcessPoolExecutor(num_jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = [
            pool.submit(fn, piece, *args, **kwargs)
            for piece in manifest.split(num_splits=num_jobs)
        ]
        return combine([job.result() for job in pending])
