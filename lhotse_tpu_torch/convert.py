"""
Carry state from the JAX package into the port.

The feature layers hold no trained weights, only constant matrices built
from their configuration; :func:`load_numpy_state` copies a JAX layer's
arrays into the matching buffers of the port's layer, so the port computes
with exactly the matrices the JAX layer holds. The augmenter's state needs
no conversion: :meth:`lhotse_tpu_torch.dataset.device_augment.OnDeviceAugmenter.load_state_dict`
takes the JAX augmenter's ``state_dict()`` dict as it is.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_numpy_state(module: nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """
    Copy numpy arrays into ``module``'s buffers of the same names: ``_fb``,
    ``_dct``, ``_lifter`` and the fused route's ``Mc``/``Ms`` (the arrays the
    JAX layer holds as ``_fb``, ``_dct``, ``_lifter`` and
    ``_fused_matrices()[:2]``).

    Raises ``KeyError`` for a name the module has no buffer for and
    ``ValueError`` for a shape or dtype mismatch; nothing is copied unless
    every array fits.
    """
    buffers = dict(module.named_buffers())
    for name, arr in arrays.items():
        if buffers.get(name) is None:
            raise KeyError(f"{type(module).__name__} has no buffer named {name!r}.")
        buf = buffers[name]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(buf.shape):
            raise ValueError(
                f"{name}: shape {tuple(arr.shape)} does not match the buffer's "
                f"{tuple(buf.shape)}.")
        if torch.from_numpy(np.empty(0, arr.dtype)).dtype != buf.dtype:
            raise ValueError(f"{name}: dtype {arr.dtype} does not match the buffer's {buf.dtype}.")
    with torch.no_grad():
        for name, arr in arrays.items():
            buffers[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    for sub in module.modules():
        refresh = getattr(sub, "_refresh_fused", None)
        if refresh is not None:
            refresh()
