"""
Iterator-graph traversal and checkpoint helpers for resumable data loading
(copied from ``lhotse_tpu/checkpoint.py``): ``detach_state`` for the
loader's per-batch snapshots, the JSON-safe ``random.Random`` state codec,
``collect_state_dict``/``restore_state_dict`` over a lazy graph, and
``DataloaderCheckpoint``, a JSON file of worker states, a sampler (or
loader) state and the topology it was taken under.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import List

from lhotse_tpu_torch.utils import Pathlike

__all__ = [
    "collect_state_dict",
    "detach_state",
    "restore_state_dict",
    "DataloaderCheckpoint",
]

_ATOMIC = (int, float, bool, str, bytes, type(None))


def detach_state(x):
    """Structural copy of a (nested) state payload that shares immutable
    subtrees and copies every mutable container — semantically equivalent to
    ``copy.deepcopy`` for JSON-shaped state (dict/list/tuple/set/ndarray of
    atoms) but several times cheaper.  The DataLoader snapshots sampler state
    after EVERY batch (exact mid-epoch resume), so this runs on the input
    pipeline's hot path."""
    if isinstance(x, _ATOMIC):
        return x
    if isinstance(x, tuple):
        copies = [detach_state(v) for v in x]
        if all(c is v for c, v in zip(copies, x)):
            return x  # tuple of immutables: safe to share
        return tuple(copies)
    if isinstance(x, list):
        return [detach_state(v) for v in x]
    if isinstance(x, dict):
        return {k: detach_state(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return type(x)(detach_state(v) for v in x)
    try:
        import numpy as _np

        if isinstance(x, _np.ndarray):
            return x.copy()
        if isinstance(x, _np.generic):
            return x
    except ImportError:  # pragma: no cover
        pass
    import copy

    return copy.deepcopy(x)


def _rng_state_to_json(rng_state) -> list:
    """Convert a ``random.Random.getstate()`` tuple to JSON-safe lists."""
    return [rng_state[0], list(rng_state[1]), rng_state[2]]


def _rng_state_from_json(data) -> tuple:
    return (data[0], tuple(data[1]), data[2])


def _children_of(node):
    """The direct child iterators of a lazy-graph node, in traversal order.
    Yields (state-dict key, child) — 'source' and 'data' hold one child,
    'sources' a list of them.  'data' covers manifest-set wrappers
    (CutSet/RecordingSet/...) whose lazy graph hangs off ``.data``."""
    from lhotse_tpu_torch.lazy import IteratorNode

    one = getattr(node, "source", None)
    if one is not None:
        yield "source", one
    many = getattr(node, "sources", None)
    if many is not None:
        yield "sources", many
    data = getattr(node, "data", None)
    if isinstance(data, IteratorNode):
        yield "data", data


def _is_checkpointable_node(node) -> bool:
    from lhotse_tpu_torch.lazy import IteratorNode

    return isinstance(node, IteratorNode) and node.is_checkpointable


def collect_state_dict(root) -> dict:
    """
    Recursively collect state from all checkpointable ``IteratorNode``s in
    the lazy iterator graph rooted at ``root``. A checkpointable node's own
    ``state_dict`` is assumed to cover its children.
    """
    from lhotse_tpu_torch.lazy import IteratorNode

    captured = {"_type": type(root).__name__}
    if _is_checkpointable_node(root):
        captured["_state"] = root.state_dict()
        return captured

    if isinstance(root, IteratorNode):
        # A non-checkpointable lazy node ANYWHERE in the graph (leaf or
        # composite) makes the checkpoint unable to resume — refuse loudly
        # instead of silently recording a from-scratch state.
        raise NotImplementedError(
            f"{type(root).__name__} does not support checkpointing. Remove it "
            f"from the pipeline or implement state_dict/load_state_dict."
        )
    # Manifest wrapper (e.g. a lazy CutSet handed in directly): recurse into
    # its ``.data`` graph so the state is actually captured — a silent empty
    # state here would restore as a from-scratch replay.  Any OTHER child
    # iterators on a non-IteratorNode keep the loud refusal: such objects
    # cannot participate in checkpointing and silently skipping them would
    # also restore as a replay.
    non_data = [key for key, _ in _children_of(root) if key != "data"]
    if non_data:
        raise NotImplementedError(
            f"{type(root).__name__} participates in iterator graph traversal "
            f"(it has child iterators) but is not an IteratorNode."
        )
    for key, child in _children_of(root):
        captured[key] = collect_state_dict(child)
    return captured


def restore_state_dict(root, state: dict) -> None:
    """
    Recursively restore state collected by :func:`collect_state_dict`. A
    checkpointable root restores its own children via ``load_state_dict``, so
    recursion happens only for non-checkpointable roots.
    """
    saved_type = state.get("_type")
    if saved_type is not None and saved_type != type(root).__name__:
        raise TypeError(
            f"Type mismatch during state restoration: expected "
            f"'{saved_type}', got '{type(root).__name__}'."
        )

    if "_state" in state and _is_checkpointable_node(root):
        root.load_state_dict(state["_state"])
        return

    for key, child in _children_of(root):
        if key not in state:
            continue
        if key in ("source", "data"):
            restore_state_dict(child, state[key])
        else:
            saved_children = state[key]
            if len(child) != len(saved_children):
                raise ValueError(
                    f"Number of children mismatch during state restoration: "
                    f"expected {len(saved_children)}, got {len(child)}."
                )
            for sub, sub_state in zip(child, saved_children):
                restore_state_dict(sub, sub_state)


@dataclass
class DataloaderCheckpoint:
    """
    Serializable container for a full dataloader checkpoint: per-worker
    iterator graph states plus the sampler state, with topology metadata
    validated on restore.
    """

    num_workers: int
    world_size: int
    rank: int
    worker_states: List[dict] = field(default_factory=list)
    sampler_state: dict = field(default_factory=dict)

    def save(self, path: Pathlike) -> None:
        payload = json.dumps(asdict(self), indent=2, default=_json_serializer)
        Path(path).write_text(payload)

    @classmethod
    def load(cls, path: Pathlike) -> "DataloaderCheckpoint":
        return cls(**json.loads(Path(path).read_text()))

    def validate(self, num_workers: int, world_size: int, rank: int = 0) -> None:
        for name, saved, current in (
            ("num_workers", self.num_workers, num_workers),
            ("world_size", self.world_size, world_size), ("rank", self.rank, rank)):
            if saved != current:
                raise ValueError(
                    f"Checkpoint {name}={saved} does not match current "
                    f"{name}={current}."
                )


def _json_serializer(obj):
    if isinstance(obj, tuple):
        return list(obj)
    raise TypeError(f"Object of type {type(obj).__name__} is not JSON serializable")
