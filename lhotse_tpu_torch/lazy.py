"""
The streaming-iterator runtime the manifest Sets are built on (copied from
``lhotse_tpu/lazy.py``): the node protocol with checkpointing, graph-origin
tokens, the JSONL and text leaves (streaming, and indexed through an
``.idx`` sidecar), the chain (with its item-level shuffle over indexed
leaves), the weighted multiplexer and the infinite approximate one behind
``CutSet.mux``/``infinite_mux``, and the shuffle, filter, map, flatten (the
one-to-many cut operations), repeat and slice combinators behind
``CutSet``'s lazy algebra.
"""
from __future__ import annotations

import os
import random
import types
import warnings
from collections import deque
from contextlib import contextmanager
from functools import partial
from json import JSONDecodeError
from typing import Any, Callable, Iterable, List, Optional, TypeVar, Union

from lhotse_tpu_torch.serialization import LazyMixin, decode_json_line, deserialize_item, open_best
from lhotse_tpu_torch.utils import Pathlike, fastcopy, is_module_available

T = TypeVar("T")

_TRUE_STRINGS = frozenset(("1", "True", "true", "yes"))


def is_dill_enabled() -> bool:
    return (
        is_module_available("dill")
        and os.environ.get("LHOTSE_DILL_ENABLED", "0") in _TRUE_STRINGS
    )


def set_dill_enabled(value: bool) -> None:
    if not is_module_available("dill"):
        raise AssertionError("Cannot enable dill because dill is not installed.")
    os.environ["LHOTSE_DILL_ENABLED"] = "1" if value else "0"


@contextmanager
def dill_enabled(value: bool):
    saved = is_dill_enabled()
    set_dill_enabled(value)
    yield
    set_dill_enabled(saved)


class Dillable:
    """
    Serializes ``__dict__`` through dill instead of pickle when the
    ``LHOTSE_DILL_ENABLED`` env var is on — the way to ship lambdas/closures
    into dataloading worker subprocesses.
    """

    def __getstate__(self):
        if is_dill_enabled():
            import dill

            return dill.dumps(self.__dict__)
        return self.__dict__

    def __setstate__(self, state):
        if is_dill_enabled():
            import dill

            state = dill.loads(state)
        self.__dict__ = state


def _warn_if_lambda(fn: Callable, owner: str) -> None:
    if (isinstance(fn, types.LambdaType) and fn.__name__ == "<lambda>" and not is_dill_enabled()):
        warnings.warn(
            f"A lambda was passed to {owner}: it may prevent forking this "
            f"process. Pass a regular function for multi-worker dataloading "
            f"(or enable dill via LHOTSE_DILL_ENABLED=1)."
        )


class GraphOriginDict(dict):
    """A dict that accepts a ``_graph_origin`` attribute (plain dicts don't)."""

    __slots__ = ("_graph_origin",)


class GraphOriginList(list):
    """A list that accepts a ``_graph_origin`` attribute (plain lists don't)."""

    __slots__ = ("_graph_origin",)


def normalize_graph_token(token: Any) -> Any:
    """Lists arriving from JSON checkpoints become the canonical tuples."""
    if isinstance(token, (list, tuple)):
        return tuple(normalize_graph_token(t) for t in token)
    return token


def attach_graph_origin(item: Any, token: Any) -> Any:
    # Cut-like objects divert unknown attributes into their serialized
    # `custom` dict; tokens are process-local runtime metadata, so write the
    # slot directly and tolerate objects that cannot carry attributes at all.
    # Plain lists/dicts (e.g. produced by a map fn exploding one item into
    # many) are upgraded to slotted subclasses — callers must use the RETURN
    # value for the token to stick on those.
    try:
        object.__setattr__(item, "_graph_origin", token)
        return item
    except Exception:
        pass
    try:
        setattr(item, "_graph_origin", token)
        return item
    except Exception:
        pass
    if type(item) is list:
        item = GraphOriginList(item)
    elif type(item) is dict:
        item = GraphOriginDict(item)
    else:
        return item
    item._graph_origin = token
    return item


def get_graph_origin(item: Any) -> Any:
    # Hot path (called per item in samplers/buffers): read the instance dict
    # directly — `getattr` misses would route through CustomFieldMixin's
    # `__getattr__` and pay an exception raise per un-stamped item.
    d = getattr(item, "__dict__", None)
    if d is not None:
        return d.get("_graph_origin")
    return getattr(item, "_graph_origin", None)


def maybe_attach_graph_origin(item: Any, token: Any) -> Any:
    return item if token is None else attach_graph_origin(item, token)


def require_graph_origin(item: Any, owner: str, what: str = "items") -> Any:
    token = get_graph_origin(item)
    if token is not None:
        return token
    raise RuntimeError(
        f"{owner} needs a '_graph_origin' token on {what}, but this item came "
        f"from a source that does not stamp them (not graph-restorable)."
    )


def supports_graph_restore(source: Any, *, require_length: bool = False) -> bool:
    """Can ``source[token]`` refetch items in constant time (optionally with len)?"""
    return (
        getattr(source, "has_constant_time_access", False)
        and hasattr(source, "__getitem__")
        and (not require_length or hasattr(source, "__len__"))
    )


def resolve_iteration_seed(seed: Optional[Union[int, str]]) -> int:
    from lhotse_tpu_torch.dataset.dataloading import resolve_seed

    return random.getrandbits(31) if seed is None else resolve_seed(seed)


class IteratorNode(Dillable, Iterable):
    """
    One vertex of a lazy pipeline.  Children live on ``self.source`` (single)
    or ``self.sources`` (many) so generic graph walks can traverse any
    pipeline.  Checkpointable nodes flip ``is_checkpointable`` and implement
    the state protocol.  Instances are not thread-safe.
    """

    is_checkpointable = False
    is_indexed = False
    has_constant_time_access = False

    def _no_state_support(self, op: str):
        raise NotImplementedError(
            f"{type(self).__name__} is not checkpointable and does not implement {op}()."
        )

    def state_dict(self) -> dict:
        self._no_state_support("state_dict")

    def load_state_dict(self, state: dict) -> None:
        self._no_state_support("load_state_dict")

    def __add__(self, other) -> "LazyIteratorChain":
        return LazyIteratorChain(self, other)

    def _no_len(self) -> int:
        raise TypeError(
            f"{type(self).__name__} does not support __len__: it would require "
            f"consuming the whole stream. Use .to_eager() first if you need the length."
        )

    def iter_children(self):
        if hasattr(self, "source"):
            yield self.source
        if hasattr(self, "sources"):
            yield from self.sources


def resolve_iterator_source(obj: Iterable) -> Iterable:
    """Peel manifest Set wrappers (CutSet & co.) down to their iterator graph."""
    try:
        from lhotse_tpu_torch.cut import CutSet
    except Exception:
        return obj
    return obj.data if isinstance(obj, CutSet) else obj


def _snapshot_child(child: Any) -> Optional[dict]:
    """A child's state_dict, or None when it is genuinely stateless."""
    if isinstance(child, IteratorNode):
        if type(child).state_dict is IteratorNode.state_dict:
            # No own state — fine for a leaf, a wiring error for a composite.
            if any(True for _ in child.iter_children()):
                raise NotImplementedError(f"{type(child).__name__} does not support checkpointing.")
            return None
        return child.state_dict()
    getter = getattr(child, "state_dict", None)
    if callable(getter):
        try:
            return getter()
        except Exception:
            return None
    return None


def _restore_child(child: Any, state: Optional[dict]) -> None:
    if state is None:
        return
    if isinstance(child, IteratorNode):
        if type(child).load_state_dict is IteratorNode.load_state_dict:
            raise NotImplementedError(
                f"{type(child).__name__} does not support checkpoint restoration."
            )
        child.load_state_dict(state)
        return
    setter = getattr(child, "load_state_dict", None)
    if callable(setter):
        setter(state)


def _restore_persistent_child(child: Any, state: Optional[dict]) -> None:
    """
    Carry a child's CROSS-PASS state (advancing RNGs, pass counters) from a
    checkpoint into a node that will be (re-)iterated from scratch — without
    marking it resumed, so positional state (buffers, drained flags, offsets)
    deliberately resets at its next ``iter()``.

    This is what composite restores must use for children that are NOT the
    active one: earlier (already consumed) or later (not yet started this
    pass) children re-iterate fresh, but an enclosing ``repeat`` will run
    them again — and a shuffler whose RNG silently rewound would replay a
    previous pass's order (the bug this fixes).
    """
    if child is None or not isinstance(state, dict):
        return
    loader = getattr(child, "load_persistent_state", None)
    if callable(loader):
        loader(state)
        return
    # Generic recursion over the two state-shape conventions: single-source
    # transforms store the child snapshot under "source"; multi-source
    # composites under "inner_states" (parallel to .sources).
    src = getattr(child, "source", None)
    if src is not None and isinstance(state.get("source"), dict):
        _restore_persistent_child(src, state["source"])
    srcs = getattr(child, "sources", None)
    if srcs and isinstance(state.get("inner_states"), list):
        for s, inner in zip(srcs, state["inner_states"]):
            _restore_persistent_child(s, inner)


class _Transform(IteratorNode):
    """
    Shared base for combinators wrapping exactly one source: index/restore
    capability, chaining, and state handling all delegate downward.
    Subclasses override what differs.
    """

    is_checkpointable = True

    def __init__(self, iterator: Iterable) -> None:
        self.source = resolve_iterator_source(iterator)

    @property
    def is_indexed(self) -> bool:
        return getattr(self.source, "is_indexed", False)

    @property
    def has_constant_time_access(self) -> bool:
        return supports_graph_restore(self.source)

    def __len__(self) -> int:
        return len(self.source)

    def state_dict(self) -> dict:
        inner = _snapshot_child(self.source)
        return {} if inner is None else {"source": inner}

    def load_state_dict(self, state: dict) -> None:
        _restore_child(self.source, state.get("source"))


class LazyTxtIterator(IteratorNode):
    """Lines of a (possibly gzipped) text file, wrapped as TextExamples."""

    is_checkpointable = True

    def __init__(self, path: Pathlike, as_text_example: bool = True) -> None:
        self.path = path
        self.as_text_example = as_text_example
        self._len = None
        self._position = 0
        self._resume = False

    def __iter__(self):
        from lhotse_tpu_torch.cut.text import TextExample

        # Eager state init: resets/resumes at iter() time so checkpoints
        # taken before the first next() already reflect this pass.
        skip = self._position if self._resume else 0
        self._resume = False
        self._position = skip

        def gen():
            n = 0
            with open_best(self.path, "r") as f:
                for raw in f:
                    n += 1
                    if n <= skip:
                        continue
                    text = raw.strip()
                    self._position = n
                    yield TextExample(text) if self.as_text_example else text
            self._len = self._len or n

        return gen()

    def state_dict(self) -> dict: return {"position": self._position}  # noqa: E704

    def load_state_dict(self, state: dict) -> None:
        self._position = state["position"]
        self._resume = True

    def __len__(self) -> int:
        if self._len is None:
            self._len = count_newlines_fast(self.path)
        return self._len


class LazyJsonlIterator(IteratorNode):
    """Raw dict stream over a JSONL file, resumable by line position."""

    is_checkpointable = True

    def __init__(self, path: Pathlike) -> None:
        self.path = path
        self._len = None
        self._position = 0
        self._resume = False

    def __iter__(self):
        # Eager state init (see LazyTxtIterator.__iter__).
        skip = self._position if self._resume else 0
        self._resume = False
        self._position = skip

        def gen():
            lineno = 0
            with open_best(self.path, "r") as f:
                for raw in f:
                    lineno += 1
                    if lineno <= skip:
                        continue
                    record = decode_json_line(raw)
                    self._position = lineno
                    yield record
            self._len = self._len or lineno

        return gen()

    def __len__(self) -> int:
        if self._len is None:
            self._len = count_newlines_fast(self.path)
        return self._len

    def state_dict(self) -> dict: return {"position": self._position}  # noqa: E704

    def load_state_dict(self, state: dict) -> None:
        self._position = state["position"]
        self._resume = True


class LazyManifestIterator(IteratorNode):
    """Typed manifests off a JSONL file (LazyJsonlIterator + deserialize_item)."""

    is_checkpointable = True

    def __init__(self, path: Pathlike) -> None:
        self.source = LazyJsonlIterator(path)

    path = property(lambda self: self.source.path)

    def __iter__(self): return map(deserialize_item, self.source)  # noqa: E704

    def __len__(self) -> int: return len(self.source)  # noqa: E704

    def state_dict(self) -> dict:
        return {"source": self.source.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.source.load_state_dict(state["source"])


class LazyIndexedManifestIterator(IteratorNode):
    """
    Manifest leaf with an ``.idx`` sidecar: O(1) ``[i]``, worker-partitioned
    and optionally Feistel-shuffled iteration, position-based checkpoints.
    """

    is_checkpointable = True
    is_indexed = True
    has_constant_time_access = True

    def __init__(
        self, path: Pathlike, shuffle: bool = False, seed: int = 0,
        index_path: Optional[Pathlike] = None, decode: Optional[Callable[[dict], Any]] = None,
        skip_decode_errors: bool = False, decode_error_callback: Optional[Callable] = None) -> None:
        from lhotse_tpu_torch.dataset.dataloading import PartitionedIndexedIterator
        from lhotse_tpu_torch.indexing import IndexedJsonlReader

        self.path = path
        self.shuffle = shuffle
        self.seed = seed
        self.index_path = index_path
        self.skip_decode_errors = skip_decode_errors
        self.decode_error_callback = decode_error_callback
        self._decode = deserialize_item if decode is None else decode
        self._reader = IndexedJsonlReader(path, index_path=index_path)
        self._iter_state = PartitionedIndexedIterator(shuffle=shuffle, seed=seed)

    def __getitem__(self, idx: int) -> Any:
        return attach_graph_origin(self._decode(self._reader[idx]), idx)

    def __iter__(self):
        # Eager: iterate() resets/resumes partition state at this call.
        positions = self._iter_state.iterate(len(self._reader))

        def gen():
            for pos in positions:
                try:
                    yield self[pos]
                except (JSONDecodeError, UnicodeDecodeError) as ex:
                    if not self.skip_decode_errors:
                        raise
                    if self.decode_error_callback is not None:
                        self.decode_error_callback(ex, pos, self.path)
                    else:
                        warnings.warn(
                            f"Skipping malformed indexed JSONL record path={self.path!r} "
                            f"idx={pos}: {type(ex).__name__}: {ex}"
                        )

        return gen()

    def __len__(self) -> int: return len(self._reader)  # noqa: E704

    def state_dict(self) -> dict:
        state = dict(self._iter_state.state_dict())
        state.update(shuffle=self.shuffle, seed=self.seed)
        return state

    def load_state_dict(self, state: dict) -> None:
        # A neutral checkpoint (taken before the first item) legitimately has
        # no permutation state: the order is fully determined by the seed.
        if self.shuffle and "range" not in state and state.get("position", 0) > 0:
            raise ValueError(
                "LazyIndexedManifestIterator with shuffle=True requires 'range' "
                "in state_dict; the checkpoint may have been created without shuffling."
            )
        self._iter_state.load_state_dict(state)
        self._restored = True


class LazyIteratorChain(IteratorNode):
    """
    Back-to-back concatenation.  ``shuffle_iters=True`` permutes sub-iterator
    order each pass, or — when every source is indexed — upgrades to a
    Feistel-permuted item-level shuffle over the whole concatenation with
    seekable (O(1)-resumable) positions.
    """

    is_checkpointable = True

    def __init__(
        self, *iterators: Iterable, shuffle_iters: bool = False,
        seed: Optional[Union[int, str]] = None) -> None:
        self.shuffle_iters = shuffle_iters
        self.seed = seed
        self.num_iters = 0
        self.sources = []
        for it in iterators:
            it = resolve_iterator_source(it)
            # Inline nested chains so the graph stays flat.
            self.sources.extend(it.sources if isinstance(it, LazyIteratorChain) else [it])
        self._at_source = 0
        self._pass_order: Optional[list] = None
        self._resume = False
        self._flat_pos = 0
        self._flat_seed = None
        self._prefix_lens = None

    @property
    def is_indexed(self) -> bool:
        return all(getattr(s, "is_indexed", False) for s in self.sources)

    @property
    def has_constant_time_access(self) -> bool:
        if self.shuffle_iters and not self.is_indexed:
            return False
        return all(supports_graph_restore(s, require_length=True) for s in self.sources)

    def _offsets(self) -> list:
        """Exclusive prefix sums of source lengths (cached)."""
        if self._prefix_lens is None:
            acc, out = 0, []
            for s in self.sources:
                out.append(acc)
                acc += len(s)
            out.append(acc)
            self._prefix_lens = out
        return self._prefix_lens

    def __getitem__(self, idx: Any) -> Any:
        idx = normalize_graph_token(idx)
        if isinstance(idx, tuple) and len(idx) == 2:
            which, inner = idx
            return attach_graph_origin(self.sources[which][inner], idx)
        from bisect import bisect_right

        offsets = self._offsets()
        total = offsets[-1]
        if idx < 0:
            idx += total
        if not 0 <= idx < total:
            raise IndexError("index out of range for LazyIteratorChain")
        which = bisect_right(offsets, idx) - 1
        return attach_graph_origin(self.sources[which][idx - offsets[which]], idx)

    def __iter__(self):
        if self.shuffle_iters and self.is_indexed:
            return self._iter_item_shuffled()
        return self._iter_by_source()

    def _iter_by_source(self):
        from lhotse_tpu_torch.dataset.dataloading import resolve_seed

        # Eager preamble: pass order + active-source iterator are set up at
        # iter() time so checkpoints taken before the first next() already
        # describe this pass (stale child states from a finished previous
        # pass must never be captured).
        if self._resume:
            self._resume = False
            first = self._at_source
            order = self._pass_order
            if order is None or len(order) != len(self.sources):
                order = list(range(len(self.sources)))
        else:
            first = 0
            order = list(range(len(self.sources)))
            if self.shuffle_iters:
                rng = (
                    random
                    if self.seed is None
                    else random.Random(resolve_seed(self.seed) + self.num_iters)
                )
                rng.shuffle(order)
                self.num_iters += 1
            self._at_source = first
        self._pass_order = order

        def source_iter(k):
            src = self.sources[order[k]]
            if isinstance(src, dict):
                src = src.values()
            return iter(src)

        first_iter = source_iter(first) if first < len(order) else iter(())
        stamp = self.has_constant_time_access and not self.shuffle_iters

        def gen():
            for k in range(first, len(order)):
                self._at_source = k
                for item in first_iter if k == first else source_iter(k):
                    if stamp:
                        item = maybe_attach_graph_origin(
                            item, (order[k], get_graph_origin(item))
                        )
                    yield item

        return gen()

    def _iter_item_shuffled(self):
        from lhotse_tpu_torch.dataset.dataloading import get_worker_partition
        from lhotse_tpu_torch.indexing import LazyShuffledRange

        worker, nworkers = get_worker_partition()
        if self._resume:
            self._resume = False
            begin = self._flat_pos
            seed0 = self._flat_seed
            if seed0 is None:
                seed0 = resolve_iteration_seed(self.seed)
            saved = (getattr(self, "_part_worker", None), getattr(self, "_part_n", None))
            if saved[1] is not None and saved != (worker, nworkers):
                raise ValueError(
                    f"LazyIteratorChain global-shuffle partition mismatch on resume: "
                    f"saved (shard_id={saved[0]}, num_shards={saved[1]}), "
                    f"current (shard_id={worker}, num_shards={nworkers})."
                )
        else:
            begin, self._flat_pos = 0, 0
            seed0 = resolve_iteration_seed(self.seed)
            self._flat_seed = seed0
        self._part_worker, self._part_n = worker, nworkers

        perm = LazyShuffledRange(
            len(self), seed=seed0 + self.num_iters, shard_id=worker, num_shards=nworkers)

        def gen():
            for i in range(begin, len(perm)):
                self._flat_pos = i + 1
                yield self[perm[i]]
            self.num_iters += 1

        return gen()

    def __len__(self) -> int: return sum(len(s) for s in self.sources)  # noqa: E704

    def state_dict(self) -> dict:
        return {
            "current_iter_idx": self._at_source, "num_iters": self.num_iters,
            "iter_order": self._pass_order, "global_position": self._flat_pos,
            "global_seed": self._flat_seed, "global_shard_id": getattr(self, "_part_worker", None),
            "global_num_shards": getattr(self, "_part_n", None),
            "inner_states": [_snapshot_child(s) for s in self.sources]}

    def load_state_dict(self, state: dict) -> None:
        self._at_source = state["current_iter_idx"]
        self.num_iters = state["num_iters"]
        self._pass_order = state.get("iter_order")
        self._flat_pos = state.get("global_position", 0)
        self._flat_seed = state.get("global_seed")
        self._part_worker = state.get("global_shard_id")
        self._part_n = state.get("global_num_shards")
        self._resume = True
        if self.shuffle_iters and self.is_indexed:
            return  # item-level mode: position alone restores everything
        order = self._pass_order or list(range(len(self.sources)))
        # Fully restore ONLY the active source: earlier ones are consumed
        # this pass, and later ones have not started — their snapshots still
        # describe the PREVIOUS pass, so marking them "resumed" would make
        # them yield nothing (or stale items). They still need their
        # CROSS-PASS state (advancing RNGs) carried over, because an
        # enclosing repeat will iterate them again next pass.
        active = {order[self._at_source]} if self._at_source < len(order) else set()
        for i, (src, inner) in enumerate(zip(self.sources, state.get("inner_states", []))):
            if inner is None:
                continue
            if i in active:
                _restore_child(src, inner)
            else:
                _restore_persistent_child(src, inner)

    def load_persistent_state(self, state: dict) -> None:
        """Cross-pass state: the pass counter drives shuffle_iters order
        (a fresh re-iteration must not replay earlier pass orders);
        children may carry RNGs of their own."""
        if "num_iters" in state:
            self.num_iters = state["num_iters"]
        for src, inner in zip(self.sources, state.get("inner_states", []) or []):
            _restore_persistent_child(src, inner)


class LazyIteratorMultiplexer(IteratorNode):
    """
    Weighted random interleave.  Each step draws one source (per-iteration
    RNG); a drained source leaves the draw pool unless ``stop_early`` ends
    the whole stream at the first exhaustion.  Checkpoints = RNG state +
    exhaustion mask + child states.
    """

    is_checkpointable = True

    def __init__(
        self, *iterators: Iterable, stop_early: bool = False,
        weights: Optional[List[Union[int, float]]] = None, seed: Union[int, str] = 0) -> None:
        self.sources = [resolve_iterator_source(it) for it in iterators]
        if len(self.sources) < 2:
            raise AssertionError("There have to be at least two iterables to multiplex.")
        self.stop_early = stop_early
        self.seed = seed
        self.weights = [1] * len(self.sources) if weights is None else weights
        if len(self.weights) != len(self.sources):
            raise AssertionError(
                f"Got {len(self.sources)} sources but {len(self.weights)} weights."
            )
        self._rng_state = None
        self._drained: Optional[list] = None
        self._resume = False

    @property
    def is_indexed(self) -> bool:
        return all(getattr(s, "is_indexed", False) for s in self.sources)

    @property
    def has_constant_time_access(self) -> bool:
        return all(supports_graph_restore(s) for s in self.sources)

    def __getitem__(self, token: Any) -> Any:
        token = normalize_graph_token(token)
        if not isinstance(token, tuple) or len(token) != 2:
            raise TypeError(
                "LazyIteratorMultiplexer expects graph tokens shaped like "
                "(source_index, source_token)."
            )
        which, inner = token
        return attach_graph_origin(self.sources[which][inner], token)

    def __iter__(self):
        from lhotse_tpu_torch.dataset.dataloading import get_worker_partition, resolve_seed

        _, nworkers = get_worker_partition()
        if nworkers > 1 and self.seed == "randomized" and self.is_indexed:
            raise ValueError(
                "LazyIteratorMultiplexer cannot use seed='randomized' under "
                "multi-shard iteration with indexed sources: the weighted source "
                "distribution would drift across ranks. Use a fixed integer seed."
            )
        # Eager preamble: iter() every child NOW — this resets (or resumes)
        # each child's state at the start of the pass, so checkpoints taken
        # before the first draw already describe this pass for all children.
        rng = random.Random(resolve_seed(self.seed))
        streams = [iter(s) for s in self.sources]
        if self._resume:
            self._resume = False
            drained = list(self._drained) if self._drained else [False] * len(streams)
            if self._rng_state is not None:
                rng.setstate(self._rng_state)
        else:
            drained = [False] * len(streams)
            self._rng_state = rng.getstate()
        self._drained = drained
        stamp = self.has_constant_time_access

        def gen():
            while (not any(drained)) if self.stop_early else (not all(drained)):
                pool = [i for i, dead in enumerate(drained) if not dead]
                pick = rng.choices(pool, weights=[self.weights[i] for i in pool], k=1)[0]
                self._rng_state = rng.getstate()
                try:
                    item = next(streams[pick])
                except StopIteration:
                    drained[pick] = True
                    continue
                if stamp:
                    inner = require_graph_origin(item, "LazyIteratorMultiplexer", "items")
                    item = attach_graph_origin(item, (pick, inner))
                yield item

        return gen()

    def __len__(self) -> int: return sum(len(s) for s in self.sources)  # noqa: E704

    def state_dict(self) -> dict:
        return {
            "rng_state": self._rng_state,
            "exhausted": list(self._drained) if self._drained is not None else None,
            "inner_states": [_snapshot_child(s) for s in self.sources]}

    def load_state_dict(self, state: dict) -> None:
        rng_state = state["rng_state"]
        if rng_state is not None and not isinstance(rng_state, tuple):
            from lhotse_tpu_torch.checkpoint import _rng_state_from_json

            rng_state = _rng_state_from_json(rng_state)
        self._rng_state = rng_state
        self._drained = state["exhausted"]
        live = (
            None
            if self._drained is None
            else {i for i, dead in enumerate(self._drained) if not dead}
        )
        for i, (src, inner) in enumerate(zip(self.sources, state.get("inner_states", []))):
            if live is None or i in live:
                _restore_child(src, inner)
            else:
                # drained this pass, but an enclosing repeat will iterate it
                # again — carry cross-pass state (advancing RNGs) only
                _restore_persistent_child(src, inner)
        self._resume = True


class LazyInfiniteApproximateMultiplexer(IteratorNode):
    """
    Endless sample-with-replacement over a (typically sharded) source pool,
    keeping at most ``max_open_streams`` iterators alive.  Approximate and
    infinite by design, hence not checkpointable.
    """

    def __init__(
        self, *iterators: Iterable, stop_early: bool = False,
        weights: Optional[List[Union[int, float]]] = None, seed: Union[int, str] = 0,
        max_open_streams: Optional[int] = None) -> None:
        self.sources = [resolve_iterator_source(it) for it in iterators]
        if not self.sources:
            raise AssertionError("infinite_mux needs at least one source.")
        self.stop_early = stop_early
        self.seed = seed
        self.weights = [1] * len(self.sources) if weights is None else weights
        if len(self.weights) != len(self.sources):
            raise AssertionError(
                f"Got {len(self.sources)} sources but {len(self.weights)} weights."
            )
        if max_open_streams is None or max_open_streams > len(self.sources):
            max_open_streams = len(self.sources)
        if max_open_streams < 1:
            raise AssertionError("max_open_streams must be at least 1.")
        self.max_open_streams = max_open_streams

    def __iter__(self):
        from lhotse_tpu_torch.dataset.dataloading import resolve_seed

        rng = random.Random(resolve_seed(self.seed))
        all_ids = range(len(self.sources))

        def open_one():
            chosen = rng.choices(all_ids, self.weights, k=1)[0]
            return iter(self.sources[chosen]), self.weights[chosen]

        slots = [open_one() for _ in range(self.max_open_streams)]
        slot_ids = list(range(self.max_open_streams))
        while True:
            live_weights = [w for _, w in slots]
            pos = rng.choices(
                slot_ids, weights=live_weights if sum(live_weights) > 0 else None, k=1)[0]
            try:
                yield next(slots[pos][0])
            except StopIteration:
                slots[pos] = open_one()
                yield next(slots[pos][0])


class LazyShuffler(_Transform):
    """
    Bounded-buffer streaming shuffle: each arriving item trades places with a
    random resident of the buffer.  When the source is graph-restorable, the
    buffer checkpoints as a list of origin tokens (O(buffer) small ints) and
    is refetched item-by-item on restore.
    """

    def __init__(
        self, iterator: Iterable, buffer_size: int = 10000, rng: Optional[random.Random] = None,
    ) -> None:
        super().__init__(iterator)
        self.buffer_size = buffer_size
        self.rng = rng if rng is not None else random.Random(random.getrandbits(64))
        self._pool = deque()
        self._warming_up = True
        self._drained = False
        self._resume = False

    @property
    def is_checkpointable(self) -> bool:
        return supports_graph_restore(self.source)

    def __getitem__(self, token: Any) -> Any:
        token = normalize_graph_token(token)
        return attach_graph_origin(self.source[token], token)

    def __iter__(self):
        # Eager: child iter() + buffer reset happen at this call so a
        # checkpoint taken before the first next() reflects this pass.
        upstream = iter(self.source)
        if self._resume:
            self._resume = False
        else:
            self._pool.clear()
            self._warming_up = True
            self._drained = False

        def pull():
            try:
                return next(upstream)
            except StopIteration:
                self._drained = True
                return None

        def trade(incoming):
            """Swap the newcomer with a random buffered item (keeps size)."""
            if not self._pool:
                return incoming
            k = self.rng.randint(0, len(self._pool) - 1)
            incoming, self._pool[k] = self._pool[k], incoming
            return incoming

        def gen():
            while not self._drained:
                item = pull()
                if item is None:
                    break
                # Opportunistically grow the buffer toward its target size.
                if len(self._pool) < self.buffer_size:
                    extra = pull()
                    if extra is not None:
                        self._pool.append(extra)
                item = trade(item)
                if self._warming_up and len(self._pool) < self.buffer_size:
                    # Not at capacity yet: park the item instead of emitting.
                    self._pool.append(item)
                    continue
                self._warming_up = False
                yield item
            while self._pool:
                yield self._pool.popleft()

        return gen()

    def state_dict(self) -> dict:
        if not self.is_checkpointable:
            raise NotImplementedError(
                "LazyShuffler supports checkpointing only with graph-restorable sources."
            )
        from lhotse_tpu_torch.checkpoint import _rng_state_to_json

        return {
            "buffer": [ require_graph_origin(x, "LazyShuffler", "buffered items") for x in self._pool ],
            "startup": self._warming_up, "source_exhausted": self._drained,
            "rng_state": _rng_state_to_json(self.rng.getstate()),
            "source": _snapshot_child(self.source)}

    def load_state_dict(self, state: dict) -> None:
        if not self.is_checkpointable:
            raise NotImplementedError(
                "LazyShuffler supports checkpointing only with graph-restorable sources."
            )
        from lhotse_tpu_torch.checkpoint import _rng_state_from_json

        _restore_child(self.source, state.get("source"))
        self._pool = deque(self.source[normalize_graph_token(t)] for t in state.get("buffer", []))
        self._warming_up = state.get("startup", True)
        self._drained = state.get("source_exhausted", False)
        self.rng.setstate(_rng_state_from_json(state["rng_state"]))
        self._resume = True

    def load_persistent_state(self, state: dict) -> None:
        """Cross-pass state only: the RNG advances every pass, so it must be
        carried even when this node re-iterates fresh (see
        _restore_persistent_child); buffer/positions reset at next iter()."""
        from lhotse_tpu_torch.checkpoint import _rng_state_from_json

        if "rng_state" in state:
            self.rng.setstate(_rng_state_from_json(state["rng_state"]))
        _restore_persistent_child(self.source, state.get("source"))


class LazyFilter(_Transform):
    """Streaming ``filter``; state lives entirely in the source."""

    def __init__(self, iterator: Iterable, predicate: Callable[[Any], bool]) -> None:
        super().__init__(iterator)
        if not callable(predicate):
            raise AssertionError(f"LazyFilter: 'predicate' arg must be callable (got {predicate}).")
        self.predicate = predicate
        _warn_if_lambda(predicate, "LazyFilter")

    def __getitem__(self, token: Any) -> Any:
        token = normalize_graph_token(token)
        item = self.source[token]
        if not self.predicate(item):
            raise RuntimeError(
                "LazyFilter received a graph restore token that does not satisfy "
                "its predicate."
            )
        return attach_graph_origin(item, token)

    def __iter__(self): return filter(self.predicate, self.source)  # noqa: E704

    def __len__(self) -> int: return self._no_len()  # noqa: E704


class LazyMapper(_Transform):
    """Streaming ``map``, optionally gated by ``apply_fn(item) -> bool``."""

    def __init__(
        self, iterator: Iterable, fn: Callable[[Any], Any],
        apply_fn: Optional[Callable[[Any], bool]] = None) -> None:
        super().__init__(iterator)
        if not callable(fn):
            raise AssertionError(f"LazyMapper: 'fn' arg must be callable (got {fn}).")
        if apply_fn is not None and not callable(apply_fn):
            raise AssertionError("LazyMapper: 'apply_fn' must be callable when given.")
        self.fn = fn
        self.apply_fn = apply_fn
        _warn_if_lambda(fn, "LazyMapper")

    def _transform(self, item: Any) -> Any:
        if self.apply_fn is None or self.apply_fn(item):
            return self.fn(item)
        return item

    def __getitem__(self, idx: Any) -> Any:
        token = normalize_graph_token(idx)
        return attach_graph_origin(self._transform(self.source[token]), token)

    def __iter__(self):
        src_iter = iter(self.source)  # eager: child resets/resumes now

        def gen():
            for item in src_iter:
                token = get_graph_origin(item)
                yield maybe_attach_graph_origin(self._transform(item), token)

        return gen()


class LazyFlattener(_Transform):
    """
    Un-nests an iterable of collections.  Checkpoints as (outer token, inner
    offset) when the outer source is graph-restorable.
    """

    def __init__(self, iterator: Iterable) -> None:
        super().__init__(iterator)
        self._outer_token = None
        self._inner_pos = 0
        self._resume = False

    @property
    def is_checkpointable(self) -> bool:
        return supports_graph_restore(self.source)

    def __getitem__(self, idx: Any) -> Any:
        token = normalize_graph_token(idx)
        if not isinstance(token, tuple) or len(token) != 2:
            raise TypeError("LazyFlattener expects graph tokens shaped like (outer, inner).")
        outer, inner = token
        item = self._fetch_inner(self.source[outer], inner)
        return attach_graph_origin(item, token)

    @staticmethod
    def _fetch_inner(collection: Any, inner: Any) -> Any:
        collection = resolve_iterator_source(collection)
        inner = normalize_graph_token(inner)
        if isinstance(inner, int):
            if hasattr(collection, "__getitem__"):
                return collection[inner]
            for k, item in enumerate(collection):
                if k == inner:
                    return item
            raise IndexError(
                f"LazyFlattener inner index {inner} out of range for "
                f"{type(collection).__name__}."
            )
        if supports_graph_restore(collection):
            return collection[inner]
        raise RuntimeError(
            "LazyFlattener received a non-integer inner graph token for a "
            "collection that does not support graph restoration."
        )

    def _walk(self, collection, outer_token, skip: int = 0):
        collection = resolve_iterator_source(collection)
        for k, item in enumerate(collection):
            if k < skip:
                continue
            self._outer_token = outer_token
            self._inner_pos = k + 1
            if outer_token is not None:
                inner = get_graph_origin(item)
                item = attach_graph_origin(
                    item, (outer_token, k if inner is None else inner)
                )
            yield item
        self._outer_token = None
        self._inner_pos = 0

    def __iter__(self):
        # Eager: resume bookkeeping + child iter() happen at this call.
        resume_token = self._outer_token if self._resume else None
        resume_skip = self._inner_pos
        self._resume = False
        outer_iter = iter(self.source)
        trackable = self.is_checkpointable

        def gen():
            if resume_token is not None:
                yield from self._walk(
                    self.source[resume_token], resume_token, skip=resume_skip)
            for group in outer_iter:
                outer = (
                    require_graph_origin(group, "LazyFlattener", "outer collections")
                    if trackable
                    else None
                )
                yield from self._walk(group, outer)

        return gen()

    def __len__(self) -> int: return self._no_len()  # noqa: E704

    def state_dict(self) -> dict:
        if not self.is_checkpointable:
            raise NotImplementedError(
                "LazyFlattener supports checkpointing only with graph-restorable "
                "outer sources."
            )
        return {
            "active_outer_token": self._outer_token, "inner_position": self._inner_pos,
            "source": _snapshot_child(self.source)}

    def load_state_dict(self, state: dict) -> None:
        if not self.is_checkpointable:
            raise NotImplementedError(
                "LazyFlattener supports checkpointing only with graph-restorable "
                "outer sources."
            )
        self._outer_token = normalize_graph_token(state.get("active_outer_token"))
        self._inner_pos = state.get("inner_position", 0)
        _restore_child(self.source, state.get("source"))
        self._resume = True


class LazyRepeater(_Transform):
    """N (or infinite) passes over the source; checkpoints (pass, source state)."""

    def __init__(
        self, iterator: Iterable, times: Optional[int] = None, preserve_id: bool = False) -> None:
        super().__init__(iterator)
        if times is not None and times <= 0:
            raise AssertionError(f"LazyRepeater times must be positive, got {times}.")
        self.times = times
        self.preserve_id = preserve_id
        self._pass_no = 0
        self._resume = False

    def __getitem__(self, idx: Any) -> Any:
        token = normalize_graph_token(idx)
        if isinstance(token, tuple) and len(token) == 2:
            pass_no, inner = token
            item = self.source[inner]
        else:
            n = len(self.source)
            pass_no, item = token // n, self.source[token % n]
        if not self.preserve_id:
            item = attach_repeat_idx_to_id(item, pass_no)
        return attach_graph_origin(item, token)

    def __iter__(self):
        resumed = self._resume
        pass_no = self._pass_no if resumed else 0
        self._resume = False
        self._pass_no = pass_no

        def pass_stream(p):
            if self.preserve_id:
                stream = self.source
            else:
                stream = LazyMapper(self.source, partial(attach_repeat_idx_to_id, idx=p))
            return iter(stream)

        # Eager child iter(): resets (or resumes) the source state at this
        # call so pre-first-next checkpoints describe the current pass.
        first_stream = (
            pass_stream(pass_no)
            if self.times is None or pass_no < self.times
            else iter(())
        )

        def gen(pass_no, resumed):
            stream = first_stream
            while self.times is None or pass_no < self.times:
                self._pass_no = pass_no
                emitted = False
                for item in stream:
                    emitted = True
                    inner = get_graph_origin(item)
                    item = maybe_attach_graph_origin(
                        item, None if inner is None else (pass_no, inner)
                    )
                    yield item
                if not emitted and not resumed:
                    return  # an empty source would loop forever otherwise
                resumed = False
                pass_no += 1
                if self.times is None or pass_no < self.times:
                    stream = pass_stream(pass_no)

        return gen(pass_no, resumed)

    def __len__(self) -> int:
        if self.times is None:
            raise TypeError(f"object of type '{type(self).__name__}' is an infinite iterator")
        return len(self.source) * self.times

    def state_dict(self) -> dict:
        state = {"current_epoch": self._pass_no}
        inner = _snapshot_child(self.source)
        if inner is not None:
            state["source"] = inner
        return state

    def load_state_dict(self, state: dict) -> None:
        self._pass_no = state["current_epoch"]
        _restore_child(self.source, state.get("source"))
        self._resume = True


class LazySlicer(_Transform):
    """
    Every n-th item starting at k — the primitive for striping one stream
    across processes.  Checkpoints how far into the source it got.
    """

    def __init__(self, iterator: Iterable, k: int, n: int) -> None:
        super().__init__(iterator)
        if k >= n:
            raise AssertionError(
                f"When selecting k-th element every n elements, k must be less "
                f"than n (got k={k} n={n})."
            )
        self.k = k
        self.n = n
        self._consumed = 0
        self._resume = False

    def __getitem__(self, idx: Any) -> Any:
        token = normalize_graph_token(idx)
        if isinstance(token, tuple) and len(token) == 2 and token[0] == "source":
            return attach_graph_origin(self.source[token[1]], token)
        if isinstance(token, int):
            return attach_graph_origin(self.source[token * self.n + self.k], idx)
        return attach_graph_origin(self.source[token], token)

    def __iter__(self):
        # Eager state init + child iter() (see LazyTxtIterator.__iter__).
        offset = self._consumed if self._resume else 0
        self._resume = False
        self._consumed = offset
        src_iter = iter(self.source)

        def gen():
            for pos, item in enumerate(src_iter, start=offset):
                self._consumed = pos + 1
                if pos % self.n != self.k:
                    continue
                inner = get_graph_origin(item)
                item = maybe_attach_graph_origin(
                    item, None if inner is None else ("source", inner)
                )
                yield item

        return gen()

    def __len__(self) -> int: return self._no_len()  # noqa: E704

    def state_dict(self) -> dict:
        state = {"source_offset": self._consumed}
        inner = _snapshot_child(self.source)
        if inner is not None:
            state["source"] = inner
        return state

    def load_state_dict(self, state: dict) -> None:
        self._consumed = state.get("source_offset", 0)
        _restore_child(self.source, state.get("source"))
        self._resume = True


class AlgorithmMixin(LazyMixin, Iterable):
    """filter/map/mux/shuffle/repeat/+ — shared by every manifest Set class."""

    def filter(self, predicate: Callable[[T], bool]):
        """Keep items satisfying ``predicate`` (stays lazy when self is lazy)."""
        cls = type(self)
        if self.is_lazy:
            return cls(LazyFilter(resolve_iterator_source(self), predicate=predicate))
        return cls.from_items(item for item in self if predicate(item))

    def map(self, transform_fn: Callable[[T], T]):
        """Apply ``transform_fn`` per item (stays lazy when self is lazy)."""
        cls = type(self)
        mapped = cls(LazyMapper(resolve_iterator_source(self), fn=transform_fn))
        return mapped if self.is_lazy else mapped.to_eager()

    @classmethod
    def mux(
        cls, *manifests, stop_early: bool = False,
        weights: Optional[List[Union[int, float]]] = None, seed: Union[int, str] = 0):
        """Weighted random interleave of several manifests (always lazy)."""
        return cls(
            LazyIteratorMultiplexer(
                *(resolve_iterator_source(m) for m in manifests),
                stop_early=stop_early,
                weights=weights,
                seed=seed,
            )
        )

    @classmethod
    def infinite_mux(
        cls, *manifests, weights: Optional[List[Union[int, float]]] = None,
        seed: Union[int, str] = 0, max_open_streams: Optional[int] = None):
        """Endless sample-with-replacement mux over a shard pool."""
        return cls(
            LazyInfiniteApproximateMultiplexer(
                *(resolve_iterator_source(m) for m in manifests),
                weights=weights,
                seed=seed,
                max_open_streams=max_open_streams,
            )
        )

    def shuffle(self, rng: Optional[random.Random] = None, buffer_size: int = 10000):
        """Shuffle items (streaming buffer shuffle when lazy)."""
        cls = type(self)
        rng = random if rng is None else rng
        if self.is_lazy:
            return cls(
                LazyShuffler(
                    resolve_iterator_source(self), buffer_size=buffer_size, rng=rng
                )
            )
        eager: List = self.data.copy()
        rng.shuffle(eager)
        return cls(eager)

    def repeat(self, times: Optional[int] = None, preserve_id: bool = False):
        """Iterate the whole set ``times`` times (forever when None)."""
        node = LazyRepeater(resolve_iterator_source(self), times=times, preserve_id=preserve_id)
        return type(self)(node)

    def __add__(self, other):
        joined = LazyIteratorChain(resolve_iterator_source(self), resolve_iterator_source(other))
        return type(self)(joined)


def attach_repeat_idx_to_id(item: Any, idx: int) -> Any:
    if not hasattr(item, "id"):
        return item
    return fastcopy(item, id=f"{item.id}_repeat{idx}")


def count_newlines_fast(path: Pathlike):
    """Newline count via 64 KiB block reads (no line splitting)."""
    total = 0
    mode = "r" if str(path) == "-" else "rb"
    with open_best(path, mode) as f:
        while True:
            block = f.read(1 << 16)
            if not block:
                return total
            total += block.count(b"\n")
