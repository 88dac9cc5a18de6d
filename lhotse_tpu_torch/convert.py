"""
Carry state from the JAX package into the port.

The feature layers hold no trained weights, only constant matrices built
from their configuration; :func:`load_numpy_state` copies a JAX layer's
arrays into the matching buffers of the port's layer, so the port computes
with exactly the matrices the JAX layer holds. The augmenter's state needs
no conversion: :meth:`lhotse_tpu_torch.dataset.device_augment.OnDeviceAugmenter.load_state_dict`
takes the JAX augmenter's ``state_dict()`` dict as it is.
:func:`encoder_state_from_jax` copies the JAX encoder's parameter tree into
the port's :class:`~lhotse_tpu_torch.models.encoder.Encoder`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def _check_and_copy(targets: Dict[str, torch.Tensor], arrays: Dict[str, np.ndarray],
                    owner: str, kind: str) -> None:
    """Copy each array into the tensor of its name, after checking every
    name, shape and dtype: nothing is copied unless every array fits."""
    for name, arr in arrays.items():
        if targets.get(name) is None:
            raise KeyError(f"{owner} has no {kind} named {name!r}.")
        target = targets[name]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(
                f"{name}: shape {tuple(arr.shape)} does not match the {kind}'s "
                f"{tuple(target.shape)}.")
        if torch.from_numpy(np.empty(0, arr.dtype)).dtype != target.dtype:
            raise ValueError(f"{name}: dtype {arr.dtype} does not match the {kind}'s {target.dtype}.")
    with torch.no_grad():
        for name, arr in arrays.items():
            targets[name].copy_(torch.as_tensor(np.array(arr)))


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
    _check_and_copy(dict(module.named_buffers()), arrays, type(module).__name__, "buffer")
    for sub in module.modules():
        refresh = getattr(sub, "_refresh_fused", None)
        if refresh is not None:
            refresh()


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A parameter tree of dicts and lists as ``{"layers.0.wqkv": array}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def encoder_state_from_jax(encoder: nn.Module, params: Any) -> None:
    """
    Copy the JAX encoder's parameter tree (``init_params``' dict of arrays,
    as numpy or anything ``np.asarray`` takes) into ``encoder``'s
    parameters, which carry the same names and shapes (``params["layers"][0]
    ["wqkv"]`` is ``layers.0.wqkv``).

    Raises ``KeyError`` for a name missing on either side and
    ``ValueError`` for a shape or a dtype (float32) that does not match;
    nothing is copied unless every array fits.
    """
    arrays = _flatten(params)
    targets = dict(encoder.named_parameters())
    missing = sorted(set(targets) - set(arrays))
    if missing:
        raise KeyError(f"the parameter tree lacks {missing}.")
    _check_and_copy(targets, arrays, type(encoder).__name__, "parameter")
