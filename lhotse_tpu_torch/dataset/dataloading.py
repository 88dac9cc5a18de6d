"""
Dataloading glue (copied from ``lhotse_tpu/dataset/dataloading.py``):
per-(rank, worker) seeds and the ``worker_init_fn`` that sets them,
special seed values, the (rank, worker) partition and
:class:`PartitionedIndexedIterator`, which drives the indexed sources'
partitioned, optionally shuffled iteration and its resume. Rank and world
size come from :mod:`lhotse_tpu_torch.parallel.mesh` (``WORLD_SIZE``/``RANK``,
then ``torch.distributed``, then 1/0) where the JAX package asks JAX's
process runtime.
"""
from __future__ import annotations

import os
import random
import secrets
import sys
import threading
from dataclasses import dataclass
from functools import partial
from typing import Callable, Generator, Optional, Tuple, Union

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


def make_worker_init_fn(
    rank: Optional[int] = None, world_size: Optional[int] = None,
    set_different_node_and_worker_seeds: bool = True, seed: Optional[int] = 42,
) -> Optional[Callable[[int], None]]:
    """Create a worker_init_fn suitable for worker subprocess initialization."""
    return partial(
        worker_init_fn, rank=rank, world_size=world_size,
        set_different_node_and_worker_seeds=set_different_node_and_worker_seeds, seed=seed)


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


class PartitionedIndexedIterator:
    """
    Partition-aware iteration driver for indexed leaf iterators: yields global
    indices of this shard's slice of ``range(total_len)``, either strided
    (shuffle=False) or Feistel-shuffled (shuffle=True), with position-based
    checkpointing and topology-validated resume.
    """

    def __init__(self, shuffle: bool = False, seed: int = 0) -> None:
        self._shuffle = shuffle
        self._seed = seed
        self._position = 0
        self._shard_id: Optional[int] = None
        self._num_shards: Optional[int] = None
        self._restored = False
        self._range = None
        self._pending_range_state = None

    @property
    def position(self) -> int:
        return self._position

    def _resume_start(self, shard_id: int, num_shards: int) -> int:
        """Resume position after topology validation (0 on a fresh pass)."""
        if not self._restored:
            self._position = 0
            return 0
        self._restored = False
        saved = (self._shard_id, self._num_shards)
        if self._num_shards is not None and saved != (shard_id, num_shards):
            raise ValueError(
                f"PartitionedIndexedIterator topology mismatch on resume: "
                f"saved (shard_id={saved[0]}, num_shards={saved[1]}), "
                f"current (shard_id={shard_id}, num_shards={num_shards})."
            )
        return self._position

    def _build_order(self, total_len: int, shard_id: int, num_shards: int) -> int:
        """Set up this pass's index order; returns the shard length."""
        if self._shuffle:
            from lhotse_tpu_torch.indexing import LazyShuffledRange

            self._range = LazyShuffledRange(
                total_len, seed=self._seed, shard_id=shard_id, num_shards=num_shards)
            if self._pending_range_state is not None:
                self._range.load_state_dict(self._pending_range_state)
                self._pending_range_state = None
            return len(self._range)
        self._range = None
        if total_len <= shard_id:
            return 0
        return (total_len - shard_id + num_shards - 1) // num_shards

    def iterate(
        self, total_len: int, partition: Optional[Tuple[int, int]] = None,
    ) -> Generator[int, None, None]:
        """``partition`` overrides the env-gated worker partition — used by
        readers whose own API requested splitting (split_for_dataloading).

        State setup (reset-or-resume, topology validation, order build) runs
        EAGERLY at the call, not at the first ``next()``: a checkpoint taken
        between starting a new pass and drawing its first item must already
        reflect this pass, not the previous one.
        """
        shard_id, num_shards = (
            partition if partition is not None else get_worker_partition()
        )
        start = self._resume_start(shard_id, num_shards)
        self._shard_id, self._num_shards = shard_id, num_shards
        shard_len = self._build_order(total_len, shard_id, num_shards)

        def gen():
            for i in range(start, shard_len):
                self._position = i + 1
                yield (
                    self._range[i]
                    if self._range is not None
                    else shard_id + i * num_shards
                )

        return gen()

    def state_dict(self) -> dict:
        sd = {
            "position": self._position, "shard_id": self._shard_id, "num_shards": self._num_shards}
        order_state = (
            self._range.state_dict()
            if self._range is not None
            else self._pending_range_state
        )
        if order_state is not None:
            sd["range"] = order_state
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self._position = sd.get("position", 0)
        self._shard_id, self._num_shards = sd.get("shard_id"), sd.get("num_shards")
        if self._shuffle:
            self._pending_range_state = sd.get("range")
            if self._pending_range_state is not None:
                # The SAVED iteration seed governs the restored permutation —
                # not whatever seed this instance was constructed with.
                self._seed = self._pending_range_state.get("seed", self._seed)
            self._range = None
        self._restored = True
