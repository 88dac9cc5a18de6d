"""Rank discovery and per-rank batch placement (port of ``lhotse_tpu/parallel/mesh.py``),
and the host pool map of ``lhotse_tpu/parallel/pool.py``."""
from lhotse_tpu_torch.parallel.mesh import (
    data_parallel_mesh, get_rank, get_world_size, host_local_to_global, local_rows,
    pad_to_multiple, shard_batch)
from lhotse_tpu_torch.parallel.pool import ParallelExecutor, SubmitterThread, parallel_map

__all__ = ["ParallelExecutor", "SubmitterThread", "data_parallel_mesh", "get_rank",
           "get_world_size",
           "host_local_to_global", "local_rows", "pad_to_multiple", "parallel_map",
           "shard_batch"]
