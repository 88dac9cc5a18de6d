"""Rank discovery and per-rank batch placement (port of ``lhotse_tpu/parallel/mesh.py``)."""
from lhotse_tpu_torch.parallel.mesh import (
    get_rank, get_world_size, host_local_to_global, local_rows, pad_to_multiple, shard_batch)

__all__ = ["get_rank", "get_world_size", "host_local_to_global", "local_rows", "pad_to_multiple",
           "shard_batch"]
