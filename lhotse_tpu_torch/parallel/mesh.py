"""
Rank discovery and per-rank batch placement (port of
``lhotse_tpu/parallel/mesh.py`` and of the rank discovery in
``lhotse_tpu/dataset/dataloading.py``).

The library's distributed story is data-parallel loading: each rank reads
its own share of the data and needs to know its rank and the world size.
Both resolve in the order ``WORLD_SIZE``/``RANK`` in the environment, then
``torch.distributed`` when a process group is initialised, then 1/0 (the
JAX package asks ``jax.process_count``/``process_index`` in the middle).

A rank's batch goes to its own card (``cuda:LOCAL_RANK``) through pinned
memory without blocking the host. Under an initialised process group with a
("data", "model") ``DeviceMesh``, :func:`local_rows` gives a rank its rows
of a global batch as a ``DTensor``. :func:`data_parallel_mesh` builds the
one-axis "data" ``DeviceMesh`` that :func:`local_rows` takes. The JAX
package's ``batch_sharding`` and ``replicated_sharding`` name JAX shardings
and have no counterpart here.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from lhotse_tpu_torch.dataset.device_augment import _to_device
from lhotse_tpu_torch.dataset.loader import _tree_device_put


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def get_world_size() -> int:
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return torch.distributed.get_world_size() if _distributed() else 1


def get_rank() -> int:
    if "RANK" in os.environ:
        return int(os.environ["RANK"])
    return torch.distributed.get_rank() if _distributed() else 0


def _local_device() -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK`` (``cuda:0`` when unset)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def pad_to_multiple(
    arr: np.ndarray, multiple: int, axis: int = 0, value: float = 0.0) -> np.ndarray:
    """Pad ``arr`` along ``axis`` so its size is divisible by ``multiple``."""
    size = arr.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, rem)
    return np.pad(arr, widths, mode="constant", constant_values=value)


def shard_batch(batch: Any, device: Optional[torch.device] = None) -> Any:
    """
    Place this rank's batch, a tree (dicts, lists, tuples) of numpy arrays,
    on ``device`` (this rank's card by default), each array's leading
    dimension zero-padded to a multiple of the world size so that the
    ranks' batches stack evenly. Other leaves pass through.
    """
    device = torch.device(device) if device is not None else _local_device()
    n = get_world_size()
    return _tree_device_put(batch, lambda x: _to_device(pad_to_multiple(x, n), device))


def host_local_to_global(batch: Any, device: Optional[torch.device] = None
                         ) -> Tuple[Any, torch.device]:
    """:func:`shard_batch` and the device it placed the batch on (where the
    JAX function returns the mesh)."""
    device = torch.device(device) if device is not None else _local_device()
    return shard_batch(batch, device), device


def data_parallel_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
                       device="cuda"):
    """
    A one-axis ``DeviceMesh`` named ``axis_name`` over the first
    ``n_devices`` ranks of the process group (all of them by default), one
    device each: the cards unless ``device`` asks for the CPU. With no
    process group initialised, a one-rank group over an in-memory store is
    started (NCCL on the card, gloo on the CPU), so a single process gets a
    mesh of its one device; a larger mesh needs one process per device,
    joined by ``torch.distributed`` first.
    """
    from torch.distributed.device_mesh import DeviceMesh

    device_type = torch.device(device).type
    if not _distributed():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} processes joined "
                             "by torch.distributed; none is initialised")
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("data_parallel_mesh on the card needs CUDA; pass device='cpu'")
        torch.distributed.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", store=torch.distributed.HashStore(),
            rank=0, world_size=1)
    world = torch.distributed.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices does not fit a group of {world} ranks")
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(axis_name,))


def local_rows(batch: torch.Tensor, mesh) -> DTensor:
    """
    This rank's rows of ``batch``, a global batch that every rank holds,
    as a ``DTensor`` sharded by rows over the mesh's "data" dim and
    replicated over its other dims: data rank ``r`` of ``n`` feeds rows
    ``[r·B/n, (r+1)·B/n)``. ``B`` must divide by ``n``.
    """
    n, r = mesh.size(mesh.mesh_dim_names.index("data")), mesh.get_local_rank("data")
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} rows does not split over {n} data ranks")
    rows = batch.shape[0] // n
    placements = [Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names]
    return DTensor.from_local(batch[r * rows:(r + 1) * rows], mesh, placements)
