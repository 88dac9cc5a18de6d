"""
Shard splitting across nodes and dataloading workers (copied from
``lhotse_tpu/shar/readers/utils.py``). Rank and world size come from
:mod:`lhotse_tpu_torch.parallel.mesh`; the worker from ``WORKER``/``NUM_WORKERS``,
then :func:`lhotse_tpu_torch.dataset.dataloading.get_worker_info`, which
reads torch's DataLoader worker info.
"""


def worker_info(group=None):
    """Return ``(rank, world_size, worker, num_workers)``."""
    import os

    from lhotse_tpu_torch.dataset.dataloading import (get_rank, get_worker_info, get_world_size)

    rank = get_rank()
    world_size = get_world_size()
    worker = 0
    num_workers = 1
    if "WORKER" in os.environ and "NUM_WORKERS" in os.environ:
        worker = int(os.environ["WORKER"])
        num_workers = int(os.environ["NUM_WORKERS"])
    else:
        wi = get_worker_info()
        if wi is not None:
            worker = wi.id
            num_workers = wi.num_workers
    return rank, world_size, worker, num_workers


def split_by_node(src, group=None):
    """Every node takes its strided subset of the shard list."""
    rank, world_size, worker, num_workers = worker_info(group=group)
    return src[rank::world_size]


def split_by_worker(src):
    """Every dataloading worker takes its strided subset of the shard list."""
    rank, world_size, worker, num_workers = worker_info()
    return src[worker::num_workers]
