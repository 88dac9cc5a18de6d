"""
Host→device stages of the input pipeline (port of the device stages of
``lhotse_tpu/dataset/loader.py``): :func:`transfer_stream` for batches
staged with ``OnDeviceAugmenter.stage(..., transfer=False)``, and
:func:`device_prefetch` for plain batch trees.

Both keep a few batches' copies in flight ahead of the consumer, so the copy
of batch N+1 overlaps the compute on batch N. The default copy goes through
pinned host memory without blocking the host; the device kernels that read
the batch are ordered after it on the current stream.

The JAX package's ``DataLoader`` is host code behind that package's import
chain and is not ported; nor is the ``sharding`` argument of
``device_prefetch``, which belongs with a multi-device mesh.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional

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

    def _transfer(item):
        staged = item[0] if isinstance(item, tuple) else item
        if isinstance(getattr(staged, "audio", None), np.ndarray):
            staged.audio = put(staged.audio)
            staged.kwargs = _tree_device_put(staged.kwargs, put)
        return item

    return _lookahead(staged_batches, lookahead, _transfer)


def device_prefetch(batches: Iterable, size: int = 2, *, device=None) -> Iterator:
    """
    Double-buffered host→device staging: copy up to ``size`` upcoming
    batches ahead of the consumer (numpy leaves only; str/int leaves pass
    through) so the transfer of batch N+1 overlaps the compute on batch N.

    :param device: the device to copy to (pinned, non-blocking for CUDA).
    """
    put = _device_put(device, "device_prefetch")
    return _lookahead(batches, size, lambda b: _tree_device_put(b, put))
