"""
Manifest combination (copied from ``lhotse_tpu/manipulation.py``): the
``combine`` the samplers use to pool their last batches across ranks.
"""
from __future__ import annotations

from functools import reduce
from operator import add
from typing import Iterable, TypeVar, Union

Manifest = TypeVar("Manifest")


def combine(*manifests: Union[Manifest, Iterable[Manifest]]) -> Manifest:
    """Combine multiple manifests of the same type into one (accepts varargs
    or a single list/tuple)."""
    parts = manifests[0] if len(manifests) == 1 else manifests
    return reduce(add, parts)
