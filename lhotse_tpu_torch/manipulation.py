"""
Manifest combination (copied from ``lhotse_tpu/manipulation.py``): the
``combine`` the samplers use to pool their last batches across ranks,
``split_parallelize_combine``, which fans a CutSet operation out over
worker processes, and ``to_manifest``, which builds the right Set from an
iterable of items (the CLI's ``filter``).
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from functools import reduce
from itertools import chain
from operator import add
from typing import Callable, Iterable, Optional, TypeVar, Union

Manifest = TypeVar("Manifest")
ManifestItem = TypeVar("ManifestItem")


def combine(*manifests: Union[Manifest, Iterable[Manifest]]) -> Manifest:
    """Combine multiple manifests of the same type into one (accepts varargs
    or a single list/tuple)."""
    parts = manifests[0] if len(manifests) == 1 else manifests
    return reduce(add, parts)


def split_parallelize_combine(
    num_jobs: int, manifest: Manifest, fn: Callable, *args, **kwargs) -> Manifest:
    """
    Split the manifest into ``num_jobs`` pieces, apply ``fn`` to each split in
    pool of spawned processes, and combine the results.
    """
    with ProcessPoolExecutor(num_jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = [
            pool.submit(fn, piece, *args, **kwargs)
            for piece in manifest.split(num_splits=num_jobs)
        ]
        return combine([job.result() for job in pending])


def to_manifest(items: Iterable[ManifestItem]) -> Optional[Manifest]:
    """Build the right Set type from an iterable of manifest items
    (None when empty)."""
    stream = iter(items)
    head = next(stream, None)
    if head is None:
        return None
    stream = chain([head], stream)

    from lhotse_tpu_torch.audio import Recording, RecordingSet
    from lhotse_tpu_torch.cut import Cut, CutSet
    from lhotse_tpu_torch.features import Features
    from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet

    builders = (
        (Recording, RecordingSet.from_recordings),
        (SupervisionSegment, SupervisionSet.from_segments), (Cut, CutSet.from_cuts))
    for kind, build in builders:
        if isinstance(head, kind):
            return build(stream)
    if isinstance(head, Features):
        raise ValueError(
            "FeatureSet generic construction from an iterable is not possible; "
            "call FeatureSet.from_features() directly instead."
        )
    raise ValueError(f"Unknown type of manifest item: {head}")
