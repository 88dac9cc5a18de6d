"""
Dataloading glue (copied from ``lhotse_tpu/dataset/dataloading.py``):
per-(rank, worker) seeds, special seed values and the (rank, worker)
partition. Rank and world size come from
:mod:`lhotse_tpu_torch.parallel.mesh` (``WORLD_SIZE``/``RANK``, then
``torch.distributed``, then 1/0) where the JAX package asks JAX's process
runtime. ``PartitionedIndexedIterator`` (indexed sources) is not ported.
"""
from __future__ import annotations

import os
import random
import secrets
import sys
import threading
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from lhotse_tpu_torch.parallel.mesh import get_rank, get_world_size
from lhotse_tpu_torch.utils import fix_random_seed

LHOTSE_PROCESS_SEED = "LHOTSE_PROCESS_SEED"
LHOTSE_USE_WORKER_PARTITION = "LHOTSE_USE_WORKER_PARTITION"


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    seed: Optional[int] = None


_WORKER_INFO: Optional[WorkerInfo] = None


_WORKER_INFO_LOCK = threading.Lock()


def set_worker_info(info: Optional[WorkerInfo]) -> None:
    """Install the worker identity for this process (called by the prefetcher)."""
    global _WORKER_INFO
    with _WORKER_INFO_LOCK:
        _WORKER_INFO = info


def get_worker_info() -> Optional[WorkerInfo]:
    """
    Returns this process's dataloading worker identity, or None in the main
    process. Sources, in order: this library's own worker context, then torch
    DataLoader worker info (when torch is already imported).
    """
    if _WORKER_INFO is not None:
        return _WORKER_INFO
    if "torch" in sys.modules:
        try:
            import torch.utils.data as tud

            wi = tud.get_worker_info()
            if wi is not None:
                return WorkerInfo(id=wi.id, num_workers=wi.num_workers, seed=wi.seed)
        except Exception:
            pass
    return None


def worker_init_fn(
    worker_id: int, rank: Optional[int] = None, world_size: Optional[int] = None,
    set_different_node_and_worker_seeds: bool = True, seed: Optional[int] = 42) -> None:
    """
    Sets per-(rank, worker) random seeds and env flags enabling worker-level
    partitioning of indexed sources (reference: dataloading.py:50).
    """
    if set_different_node_and_worker_seeds:
        process_seed = seed + 100 * worker_id
        if rank is not None:
            process_seed += 100000 * rank
        fix_random_seed(process_seed)
        os.environ[LHOTSE_PROCESS_SEED] = str(process_seed)

    if rank is None and world_size is None:
        return
    assert (
        rank is not None and world_size is not None
    ), f"Both args must be not None: rank={rank}, world_size={world_size}"
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    os.environ[LHOTSE_USE_WORKER_PARTITION] = "1"


def resolve_seed(seed: Union[int, str, None]) -> int:
    """
    Resolve special seed values:
    - int: returned as-is.
    - None: Python's global random state's first word.
    - "randomized": per-worker seed assigned by ``worker_init_fn`` (falls back
      to the global seed outside workers).
    - "trng": true randomness from the OS.
    """
    if isinstance(seed, int):
        return seed
    if seed is None:
        return random.getstate()[1][0]
    if seed == "randomized":
        wi = get_worker_info()
        if wi is None:
            return random.getstate()[1][0]
        if wi.seed is not None and LHOTSE_PROCESS_SEED not in os.environ:
            return int(wi.seed) % (2**31)
        assert LHOTSE_PROCESS_SEED in os.environ, (
            "Requested seed='randomized' but worker_init_fn was not called "
            "for this dataloading worker."
        )
        return int(os.environ[LHOTSE_PROCESS_SEED])
    if seed == "trng":
        return secrets.randbelow(2**31)
    raise ValueError(
        f"Unexpected type or value of seed: {type(seed)=} {seed=}. "
        f"Supported values are: None, int, 'trng', and 'randomized'."
    )


def get_worker_partition() -> Tuple[int, int]:
    """
    Resolve the global ``(shard_id, num_shards)`` partition combining the DP
    rank with the dataloading worker id:
    ``shard_id = rank * num_workers + worker_id``,
    ``num_shards = world_size * num_workers``.
    Returns (0, 1) unless worker partitioning was activated via
    ``worker_init_fn`` (reference: dataloading.py:139).
    """
    if os.environ.get(LHOTSE_USE_WORKER_PARTITION) != "1":
        return 0, 1
    rank = get_rank()
    world_size = get_world_size()
    wi = get_worker_info()
    if wi is None:
        worker_id, num_workers = 0, 1
    else:
        worker_id = wi.id
        num_workers = max(wi.num_workers, 1)
    return rank * num_workers + worker_id, world_size * num_workers
