"""
Streaming manifests out of an ``.idxpack`` (see :mod:`lhotse_tpu_torch.index_pack`).

A pack fuses the ``.idx`` sidecars of many jsonl shards into one mmap-able
file, so a sharded manifest collection behaves like a single random-access
sequence: O(1) ``[i]``, deterministic Feistel-shuffled iteration, per-worker
partitioning, and cursor-based checkpointing — with exactly one small read
per record (``os.pread`` through a bounded fd pool).

Copied from ``lhotse_tpu/packed_lazy.py``: the orders, records and state
dicts equal the JAX package's for the same pack and seed.
"""
from __future__ import annotations

import os
import threading
import warnings
from collections import OrderedDict
from collections.abc import Callable
from dataclasses import asdict, dataclass
from json import JSONDecodeError
from typing import Any, Optional, Union

from lhotse_tpu_torch.index_pack import IndexPack, open_index_pack
from lhotse_tpu_torch.lazy import (
    IteratorNode, attach_graph_origin, normalize_graph_token, resolve_iteration_seed)
from lhotse_tpu_torch.serialization import decode_json_line, deserialize_item
from lhotse_tpu_torch.utils import is_valid_url


# ---------------------------------------------------------------------------
# Descriptor pool
# ---------------------------------------------------------------------------
class _FdPool:
    """
    Process-wide LRU of O_RDONLY descriptors used for packed record reads.

    One pool serves every IndexPack in the process (paths are distinct
    anyway); it drops all descriptors when it notices a fork, because a
    child must never reuse the parent's fds.
    """

    def __init__(self, capacity: int = 128):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._owner_pid = os.getpid()
        self._open: "OrderedDict[str, int]" = OrderedDict()

    def pread(self, path: str, start: int, end: int) -> bytes:
        """Exact half-open byte range [start, end); raises EOFError if short."""
        if is_valid_url(path):
            raise ValueError(
                f"Packed record reads need a local file (got URL {path!r}); "
                "download or mount the shards first."
            )
        if not 0 <= start <= end:
            raise ValueError(f"Invalid packed byte range: [{start}, {end})")
        fd = self._checkout(path)
        want = end - start
        parts, at = [], start
        while at < end:
            piece = os.pread(fd, end - at, at)
            if not piece:
                raise EOFError(
                    f"{path}: wanted {want} bytes at offset {start}, file ended "
                    f"after {at - start}"
                )
            parts.append(piece)
            at += len(piece)
        return b"".join(parts)

    def shrink(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError("fd pool capacity must be positive")
        with self._lock:
            self.capacity = min(self.capacity, capacity)
            self._evict_locked()

    def _checkout(self, path: str) -> int:
        with self._lock:
            if self._owner_pid != os.getpid():
                # Post-fork: inherited descriptors are unsafe to share.
                self._open.clear()
                self._owner_pid = os.getpid()
            fd = self._open.pop(path, None)
            if fd is None:
                fd = os.open(path, os.O_RDONLY)
            self._open[path] = fd  # most-recently-used at the tail
            self._evict_locked()
            return fd

    def _evict_locked(self) -> None:
        while len(self._open) > self.capacity:
            _, stale = self._open.popitem(last=False)
            os.close(stale)


_POOL = _FdPool()


def read_packed_range(
    index_pack: IndexPack, path: str, start: int, end: int, *, max_open_files: int = 32) -> bytes:
    """Read one packed record's bytes through the shared descriptor pool."""
    del index_pack  # pooling is global; kept in the signature for parity
    _POOL.shrink(max(max_open_files, 1) if max_open_files else 1)
    return _POOL.pread(path, start, end)


# ---------------------------------------------------------------------------
# Iterator
# ---------------------------------------------------------------------------
@dataclass
class _Cursor:
    """Where iteration stands; everything needed to resume exactly here."""

    epoch: int = 0  # completed passes (salts the shuffle seed)
    shard: int = 0  # sequential mode: shard being consumed
    taken: int = 0  # sequential mode: records this worker consumed in shard
    rank: int = 0  # shuffled mode: next position in the permutation
    seed: Optional[int] = None  # shuffled mode: resolved base seed of this pass
    part: Optional[tuple] = None  # (worker_id, num_workers) the cursor belongs to

    def as_state(self) -> dict:
        d = asdict(self)
        d["part"] = list(self.part) if self.part is not None else None
        return d

    @classmethod
    def from_state(cls, d: dict) -> "_Cursor":
        part = d.get("part")
        return cls(
            epoch=d.get("epoch", 0), shard=d.get("shard", 0), taken=d.get("taken", 0),
            rank=d.get("rank", 0), seed=d.get("seed"),
            part=tuple(part) if part is not None else None)


class LazyPackedManifestIterator(IteratorNode):
    """
    One virtual manifest sequence over all shards of a packed collection.

    Records are addressed by graph tokens: a plain ``int`` indexes the
    concatenation of all shards; a ``(shard, local)`` pair addresses a record
    inside one shard.  Both work with ``[]`` and both appear as graph-origin
    tokens on yielded items, which is what makes buffered-downstream
    checkpoints O(1).

    Sequential iteration deals records of each shard round-robin to
    dataloading workers; ``shuffle_shards=True`` instead walks a seekable
    Feistel permutation of the whole collection (partitioned by position).
    Both modes resume exactly via ``state_dict``/``load_state_dict``.

    Example::

        key = index_pack_collection_key(
            role="records", kind="json-lines", source_spec="cuts-{000..127}.jsonl"
        )
        cuts = CutSet(LazyPackedManifestIterator("data.idxpack", key))
    """

    is_checkpointable = True
    is_indexed = True
    has_constant_time_access = True

    def __init__(
        self, index_pack, collection_key: Union[bytes, str], *, shuffle_shards: bool = False,
        seed: int = 0, decode: Optional[Callable[[dict], Any]] = None,
        skip_decode_errors: bool = False,
        decode_error_callback: Optional[ Callable[[BaseException, int, str], None] ] = None,
        max_open_files: int = 32):
        if max_open_files < 1:
            raise ValueError("max_open_files must be positive")
        self.index_pack = (
            index_pack
            if isinstance(index_pack, IndexPack)
            else open_index_pack(index_pack)
        )
        self.collection_key = collection_key
        self.collection = self.index_pack.collection(collection_key)
        self.shuffle_shards = shuffle_shards
        self.seed = seed
        self.skip_decode_errors = skip_decode_errors
        self.decode_error_callback = decode_error_callback
        self.max_open_files = max_open_files
        self._decode = deserialize_item if decode is None else decode
        self._cursor = _Cursor()
        self._resume_pending = False

    # -- random access --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.collection)

    def __getitem__(self, token):
        item, _ = self.read_with_location(token)
        return item

    def read_with_location(self, token):
        """Decode a record and also return its (path, byte-range) location."""
        token = normalize_graph_token(token)
        flat, where = self._resolve(token)
        raw = read_packed_range(
            self.index_pack, where.path, where.start, where.end, max_open_files=self.max_open_files,
        ).decode("utf-8")
        try:
            item = self._decode(decode_json_line(raw))
        except JSONDecodeError as ex:
            head = raw[:120].replace("\n", "\\n").replace("\r", "\\r")
            raise JSONDecodeError(
                f"{ex.msg} — record #{flat} of packed collection " f"(pack={str(self.index_pack.path)!r}, shard file={where.path!r}, " f"bytes [{where.start}, {where.end})), starts with: {head!r}",
                ex.doc, ex.pos) from ex
        return attach_graph_origin(item, token), where

    def _resolve(self, token):
        """Token -> (flat_index, PackedIndexLocation)."""
        if isinstance(token, tuple) and len(token) == 2:
            shard, local = token
            where = self.collection.locate_in_shard(shard, local)
            flat = (
                sum(
                    self.collection.shard_length(s)
                    for s in range(where.shard_index)
                )
                + where.local_index
            )
            return flat, where
        if not isinstance(token, int):
            raise TypeError(f"Packed manifest tokens are int or (shard, local); got {token!r}")
        flat = token if token >= 0 else token + len(self.collection)
        return flat, self.collection.locate(flat)

    # -- iteration -------------------------------------------------------------

    def __iter__(self):
        worker, nworkers = self._current_partition()
        cur = self._take_cursor(worker, nworkers)
        if self.shuffle_shards:
            return self._walk_permuted(cur, worker, nworkers)
        return self._walk_in_order(cur, worker, nworkers)

    def _current_partition(self):
        from lhotse_tpu_torch.dataset.dataloading import get_worker_partition

        return get_worker_partition()

    def _take_cursor(self, worker: int, nworkers: int) -> _Cursor:
        """Consume a pending resume cursor, or mint a fresh one."""
        if self._resume_pending:
            self._resume_pending = False
            cur = self._cursor
            if cur.part is not None and tuple(cur.part) != (worker, nworkers):
                raise ValueError(
                    "Cannot resume a packed manifest checkpoint under a different "
                    f"dataloading layout: checkpoint was worker {cur.part[0]} of "
                    f"{cur.part[1]}, this process is worker {worker} of {nworkers}."
                )
        else:
            cur = _Cursor(epoch=self._cursor.epoch)
        cur.part = (worker, nworkers)
        self._cursor = cur
        return cur

    def _walk_permuted(self, cur: _Cursor, worker: int, nworkers: int):
        from lhotse_tpu_torch.indexing import LazyShuffledRange

        if cur.seed is None:
            cur.seed = resolve_iteration_seed(self.seed)
        perm = LazyShuffledRange(
            len(self), seed=cur.seed + cur.epoch, shard_id=worker, num_shards=nworkers)
        while cur.rank < len(perm):
            token = perm[cur.rank]
            cur.rank += 1
            item = self._try_decode(token)
            if item is not None:
                yield item
        cur.epoch += 1
        cur.rank = 0
        cur.seed = None

    def _walk_in_order(self, cur: _Cursor, worker: int, nworkers: int):
        nshards = self.collection.sequence_count
        while cur.shard < nshards:
            size = self.collection.shard_length(cur.shard)
            # This worker owns locals worker, worker+nworkers, ...
            local = worker + cur.taken * nworkers
            while local < size:
                cur.taken += 1
                item = self._try_decode((cur.shard, local))
                if item is not None:
                    yield item
                local = worker + cur.taken * nworkers
            cur.shard += 1
            cur.taken = 0
        cur.epoch += 1
        cur.shard = 0

    def _try_decode(self, token):
        try:
            return self[token]
        except (JSONDecodeError, UnicodeDecodeError) as ex:
            if not self.skip_decode_errors:
                raise
            flat, where = self._resolve(normalize_graph_token(token))
            if self.decode_error_callback is not None:
                self.decode_error_callback(ex, flat, where.path)
            else:
                warnings.warn(
                    f"Dropping undecodable packed record #{flat} " f"({where.path}): {ex}",
                    stacklevel=2)
            return None

    # -- checkpointing ----------------------------------------------------------

    def state_dict(self) -> dict:
        return {"packed_cursor": self._cursor.as_state(), "shuffled": self.shuffle_shards}

    def load_state_dict(self, state: dict) -> None:
        self._cursor = _Cursor.from_state(state.get("packed_cursor", {}))
        self._resume_pending = True

    def close(self) -> None:
        """Nothing to do: descriptors live in the shared process pool."""
        return

    # The epoch counter doubles as the reference's `num_iters` attribute.
    @property
    def num_iters(self) -> int:
        return self._cursor.epoch
