"""
``.idxpack``: many ``.idx`` sidecars fused into one mmap-able file.

A sharded dataset usually ships one little-endian-uint64 offset sidecar per
shard.  Opening thousands of them costs a filesystem round-trip and an
in-memory offset array each; an index pack replaces all of that with a single
immutable file read through one mmap:

========================  ====================================================
section                   contents
========================  ====================================================
header (256 B)            magic ``IDXPACK2``, section table, layout SHA-256
collection catalog        rows keyed by SHA-256 of (role, kind, source_spec)
shard sequences           (segment id, cumulative record count) per shard
segment table             deduplicated sources: path + offsets payload + CRC32
string table              UTF-8 blob for paths and kinds
offset payloads           the concatenated ``.idx`` contents (uint64 aligned)
========================  ====================================================

Copied from ``lhotse_tpu/index_pack.py``: a pack written by either package
is byte-equal to the other's, and each opens the other's. The layout also
matches upstream lhotse's ``lhotse/index_pack.py`` bit for bit.
"""
from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
import uuid
import weakref
import zlib
from collections.abc import Mapping, Sequence
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Optional, Union

from lhotse_tpu_torch.indexing import index_file_path
from lhotse_tpu_torch.utils import is_valid_url

# --- on-disk constants (frozen: pack interchange depends on them) -----------
_MAGIC = b"IDXPACK2"
_VERSION = 2
_HEADER_SIZE = 256

# magic, version, header size, then (offset, count-or-size) pairs for the
# collections / sequences / segments / strings / offsets sections, then the
# 32-byte layout digest.
_HEADER = struct.Struct("<8sIIQQQQQQQQQQ32s")
_COLLECTION = struct.Struct("<32sQQQQII")
_SEQUENCE = struct.Struct("<QQ")
_SEGMENT = struct.Struct("<QQIIQQQII")
_U64 = struct.Struct("<Q")

_COLLECTION_PATHS_ONLY = 1
_SEGMENT_PATH_ONLY = 1


class _ColRow(NamedTuple):
    """One collection-catalog row, as stored."""

    key: bytes
    seq_start: int
    seq_count: int
    total_records: int
    kind_pos: int
    kind_len: int
    flags: int


class _SegRow(NamedTuple):
    """One segment-table row, as stored."""

    path_pos: int
    offsets_pos: int
    path_len: int
    flags: int
    offsets_count: int
    source_size: int
    offsets_size: int
    crc32: int
    reserved: int


def _identity_check(role: str, kind: str) -> None:
    if not isinstance(role, str) or not role:
        raise ValueError(f"Index-pack role must be a non-empty string, got {role!r}")
    if not isinstance(kind, str) or not kind:
        raise ValueError(f"Index-pack kind must be a non-empty string, got {kind!r}")


def _json_canonical(value):
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, Mapping):
        return {str(k): _json_canonical(value[k]) for k in sorted(value, key=str)}
    if isinstance(value, Sequence) and not isinstance(value, (str, bytes, bytearray)):
        return [_json_canonical(v) for v in value]
    return value


def index_pack_collection_key(role: str, kind: str, source_spec) -> bytes:
    """Stable SHA-256 identity of one logical collection."""
    _identity_check(role, kind)
    blob = json.dumps(
        {"kind": kind, "role": role, "source_spec": _json_canonical(source_spec)},
        ensure_ascii=False, separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).digest()


@dataclass(frozen=True)
class IndexPackCollectionSpec:
    """
    Build input: one ordered logical collection.  ``role``/``kind``/
    ``source_spec`` define the catalog key; ``paths`` are the concrete shard
    files (each needing an ``.idx`` sidecar unless ``offsets_required=False``,
    which records paths only).
    """

    role: str
    kind: str
    source_spec: object
    paths: tuple
    offsets_required: bool = True

    def __post_init__(self):
        _identity_check(self.role, self.kind)
        object.__setattr__(self, "paths", tuple(str(p) for p in self.paths))

    @property
    def key(self) -> bytes:
        return index_pack_collection_key(self.role, self.kind, self.source_spec)


@dataclass(frozen=True)
class PackedIndexLocation:
    """Where one logical record's bytes live."""

    path: str
    start: int
    end: int
    segment_id: int
    shard_index: int
    local_index: int


# ===========================================================================
# Writing
# ===========================================================================
@dataclass(frozen=True)
class _SidecarInfo:
    """Pre-scan result for one physical source going into the pack."""

    path: str
    index_path: Optional[Path]
    offsets_count: int
    source_size: Optional[int]
    path_only: bool = False

    @property
    def num_records(self) -> int:
        return self.offsets_count - 1


def _scan_sidecar(path: str, indexes_root, *, offsets_required: bool) -> _SidecarInfo:
    """Validate one source's sidecar and collect its geometry."""
    if not offsets_required:
        return _SidecarInfo(
            path=path, index_path=None, offsets_count=1, source_size=0, path_only=True)
    idx = index_file_path(path, indexes_root)
    if is_valid_url(str(idx)):
        raise ValueError(
            "Index-pack conversion currently requires a local sidecar; "
            f"got remote index path: {idx}"
        )
    idx = Path(idx)
    try:
        idx_stat = idx.stat()
    except FileNotFoundError as ex:
        raise FileNotFoundError(f"Missing .idx sidecar for {path}: {idx}") from ex
    if idx_stat.st_size < _U64.size or idx_stat.st_size % _U64.size:
        raise ValueError(
            f"Invalid .idx sidecar {idx}: size must be a positive multiple of "
            f"{_U64.size}, got {idx_stat.st_size}"
        )
    source_size = None
    if not is_valid_url(str(path)):
        try:
            src_stat = Path(path).stat()
        except FileNotFoundError as ex:
            raise FileNotFoundError(f"Indexed source not found: {path}") from ex
        if src_stat.st_mtime_ns > idx_stat.st_mtime_ns:
            raise ValueError(
                f"Source {path} is newer than index sidecar {idx}; rebuild the "
                f".idx before packing"
            )
        source_size = src_stat.st_size
    return _SidecarInfo(
        path=path, index_path=idx, offsets_count=idx_stat.st_size // _U64.size,
        source_size=source_size)


class _Strings:
    """Deduplicating UTF-8 blob builder: add() -> (position, length)."""

    def __init__(self):
        self.blob = bytearray()
        self._seen: dict = {}

    def add(self, text: str):
        raw = text.encode("utf-8")
        spot = self._seen.get(raw)
        if spot is None:
            spot = (len(self.blob), len(raw))
            self._seen[raw] = spot
            self.blob.extend(raw)
        return spot


def _layout_digest(collections: Sequence[IndexPackCollectionSpec]) -> bytes:
    h = hashlib.sha256()
    for c in collections:
        h.update(c.key)
        h.update(bytes((c.offsets_required,)))
        h.update(_U64.pack(len(c.paths)))
        for p in c.paths:
            raw = p.encode("utf-8")
            h.update(_U64.pack(len(raw)))
            h.update(raw)
    return h.digest()


class _PackBuilder:
    """Assembles one pack: plan sections, then stream everything to disk."""

    def __init__(self, collections, indexes_root):
        self.collections = collections
        self.indexes_root = indexes_root
        self.strings = _Strings()
        self.sidecars: list = []  # deduplicated _SidecarInfo, by segment id
        self.sequences: list = []  # (segment_id, cumulative_records)
        self.catalog: list = []  # staged collection rows (kind pos is blob-relative)
        self._dedup: dict = {}

    # -- planning ---------------------------------------------------------------

    def plan(self) -> None:
        seen_keys = set()
        for spec in self.collections:
            if spec.key in seen_keys:
                raise ValueError(
                    "Duplicate collection key in index pack. Distinguish repeated "
                    f"logical collections with a different role/source spec: "
                    f"{spec.source_spec!r}"
                )
            seen_keys.add(spec.key)
            first_seq = len(self.sequences)
            running = 0
            for path in spec.paths:
                seg_id = self._segment_for(path, spec.offsets_required)
                running += self.sidecars[seg_id].num_records
                self.sequences.append((seg_id, running))
            kind_spot = self.strings.add(spec.kind)
            self.catalog.append(
                (
                    spec.key,
                    first_seq,
                    len(spec.paths),
                    running,
                    kind_spot,
                    0 if spec.offsets_required else _COLLECTION_PATHS_ONLY,
                )
            )
        self.path_spots = [self.strings.add(sc.path) for sc in self.sidecars]

        # Section layout.
        self.collection_offset = _HEADER_SIZE
        self.sequence_offset = (self.collection_offset + len(self.catalog) * _COLLECTION.size)
        self.segment_offset = self.sequence_offset + len(self.sequences) * _SEQUENCE.size
        self.strings_offset = self.segment_offset + len(self.sidecars) * _SEGMENT.size
        raw_offsets_offset = self.strings_offset + len(self.strings.blob)
        self.offsets_offset = raw_offsets_offset + (-raw_offsets_offset) % _U64.size
        self.offsets_size = sum(sc.offsets_count * _U64.size for sc in self.sidecars)

    def _segment_for(self, path: str, offsets_required: bool) -> int:
        handle = (path, offsets_required)
        seg_id = self._dedup.get(handle)
        if seg_id is None:
            seg_id = len(self.sidecars)
            self._dedup[handle] = seg_id
            self.sidecars.append(
                _scan_sidecar(path, self.indexes_root, offsets_required=offsets_required)
            )
        return seg_id

    # -- emission ----------------------------------------------------------------

    def emit(self, out) -> None:
        head = _HEADER.pack(
            _MAGIC, _VERSION, _HEADER_SIZE, self.collection_offset, len(self.catalog),
            self.sequence_offset, len(self.sequences), self.segment_offset, len(self.sidecars),
            self.strings_offset, len(self.strings.blob), self.offsets_offset, self.offsets_size,
            _layout_digest(self.collections))
        out.write(head)
        out.write(b"\0" * (_HEADER_SIZE - len(head)))

        for key, first_seq, nseq, total, (kind_rel, kind_len), flags in self.catalog:
            out.write(
                _COLLECTION.pack(
                    key, first_seq, nseq, total,
                    self.strings_offset + kind_rel, kind_len, flags,
                )
            )
        for row in self.sequences:
            out.write(_SEQUENCE.pack(*row))

        # Segment rows need payload CRCs; reserve space now, backfill later.
        out.write(b"\0" * (len(self.sidecars) * _SEGMENT.size))
        out.write(bytes(self.strings.blob))
        if out.tell() < self.offsets_offset:
            out.write(b"\0" * (self.offsets_offset - out.tell()))

        seg_rows = self._copy_payloads(out)

        if out.tell() != self.offsets_offset + self.offsets_size:
            raise AssertionError(
                f"Internal idxpack size mismatch: {out.tell()} != "
                f"{self.offsets_offset + self.offsets_size}"
            )
        out.seek(self.segment_offset)
        for row in seg_rows:
            out.write(_SEGMENT.pack(*row))
        out.flush()
        os.fsync(out.fileno())

    def _copy_payloads(self, out) -> list:
        rows = []
        cursor = self.offsets_offset
        for seg_id, sc in enumerate(self.sidecars):
            expected = sc.offsets_count * _U64.size
            crc, copied, last = self._stream_one(out, sc)
            if copied != expected:
                raise ValueError(
                    f"Index changed while packing {sc.index_path}: "
                    f"expected {expected} bytes, copied {copied}"
                )
            if last is None:
                raise ValueError(f"Index sidecar contains no sentinel: {sc.index_path}")
            source_size = last if sc.source_size is None else sc.source_size
            if last != source_size:
                raise ValueError(
                    f"Invalid sentinel in {sc.index_path}: "
                    f"metadata={source_size}, payload={last}"
                )
            path_rel, path_len = self.path_spots[seg_id]
            rows.append(
                _SegRow(
                    path_pos=self.strings_offset + path_rel,
                    offsets_pos=cursor,
                    path_len=path_len,
                    flags=_SEGMENT_PATH_ONLY if sc.path_only else 0,
                    offsets_count=sc.offsets_count,
                    source_size=source_size,
                    offsets_size=expected,
                    crc32=crc & 0xFFFFFFFF,
                    reserved=0,
                )
            )
            cursor += expected
        return rows

    @staticmethod
    def _stream_one(out, sc: _SidecarInfo):
        """Copy one sidecar payload; returns (crc32, bytes copied, last u64)."""
        if sc.path_only:
            sentinel = _U64.pack(0)
            out.write(sentinel)
            return zlib.crc32(sentinel), len(sentinel), 0
        crc, copied, last = 0, 0, None
        with sc.index_path.open("rb") as src:
            while block := src.read(1024 * 1024):
                if len(block) % _U64.size:
                    raise ValueError(f"Index chunk is not uint64-aligned: {sc.index_path}")
                for (value,) in struct.iter_unpack("<Q", block):
                    if last is not None and value < last:
                        raise ValueError(
                            f"Non-monotonic offsets in {sc.index_path}: "
                            f"{value} follows {last}"
                        )
                    last = value
                crc = zlib.crc32(block, crc)
                copied += len(block)
                out.write(block)
        return crc, copied, last


def write_index_pack(
    output_path, collections: Sequence[IndexPackCollectionSpec], *, indexes_root=None,
    overwrite: bool = False) -> Path:
    """
    Fuse existing ``.idx`` sidecars into one atomic ``.idxpack``.

    Sidecars are validated while copying (uint64 alignment, monotonic
    offsets, sentinel == source size, not older than the source); identical
    physical sources are stored once.  The pack is written to a temp sibling
    and atomically published.
    """
    output_path = Path(output_path)
    collections = tuple(collections)
    if not collections:
        raise ValueError("Cannot build an index pack without collections.")
    if output_path.exists() and not overwrite:
        raise FileExistsError(f"Index pack already exists: {output_path}")
    output_path.parent.mkdir(parents=True, exist_ok=True)

    builder = _PackBuilder(collections, indexes_root)
    builder.plan()

    scratch = output_path.with_name(f".{output_path.name}.tmp.{os.getpid()}.{uuid.uuid4().hex}")
    try:
        with scratch.open("w+b") as out:
            builder.emit(out)
        if overwrite:
            os.replace(scratch, output_path)
        else:
            try:
                os.link(scratch, output_path)
            except FileExistsError as ex:
                raise FileExistsError(f"Index pack already exists: {output_path}") from ex
            scratch.unlink()
        _fsync_directory(output_path.parent)
    finally:
        if scratch.exists():
            scratch.unlink()
    return output_path


# ===========================================================================
# Reading
# ===========================================================================
class PackedIndexCollection:
    """
    Zero-copy view of one logical collection: maps collection-global or
    shard-local record indices to (path, start, end) ranges with a couple of
    mmap reads — no shard catalogs or offset arrays in memory.
    """

    def __init__(
        self, pack: "IndexPack", key: bytes, sequence_start: int, sequence_count: int,
        total_records: int, kind: str, offsets_required: bool):
        self.pack, self.key = pack, key
        self.sequence_start, self.sequence_count = sequence_start, sequence_count
        self.total_records = total_records
        self.kind, self.offsets_required = kind, offsets_required

    def __len__(self) -> int:
        return self.total_records

    def _shard(self, shard_index: int) -> int:
        if shard_index < 0:
            shard_index += self.sequence_count
        if not 0 <= shard_index < self.sequence_count:
            raise IndexError(
                f"shard index {shard_index} out of range for packed collection "
                f"with {self.sequence_count} shards"
            )
        return shard_index

    def _cumulative_before(self, shard_index: int) -> int:
        if shard_index == 0:
            return 0
        return self.pack._sequence(self.sequence_start + shard_index - 1)[1]

    def path_for_shard(self, shard_index: int) -> str:
        """Concrete source path of one logical shard."""
        shard_index = self._shard(shard_index)
        seg_id, _ = self.pack._sequence(self.sequence_start + shard_index)
        return self.pack._segment_path(seg_id)

    def shard_length(self, shard_index: int) -> int:
        """Record count of one logical shard."""
        shard_index = self._shard(shard_index)
        _, through = self.pack._sequence(self.sequence_start + shard_index)
        return through - self._cumulative_before(shard_index)

    def locate_in_shard(self, shard_index: int, local_index: int) -> PackedIndexLocation:
        """Shard-local record index -> byte range in the source file."""
        shard_index = self._shard(shard_index)
        size = self.shard_length(shard_index)
        if local_index < 0:
            local_index += size
        if not 0 <= local_index < size:
            raise IndexError(
                f"local index {local_index} out of range for packed shard "
                f"{shard_index} with {size} records"
            )
        pack = self.pack
        seg_id, _ = pack._sequence(self.sequence_start + shard_index)
        seg = pack._segment(seg_id)
        lo = pack._u64(seg.offsets_pos + local_index * _U64.size)
        hi = pack._u64(seg.offsets_pos + (local_index + 1) * _U64.size)
        if hi < lo or hi > seg.source_size:
            raise ValueError(
                f"Corrupt idxpack offsets for segment {seg_id}: "
                f"[{lo}, {hi}) outside source size {seg.source_size}"
            )
        return PackedIndexLocation(
            path=pack._segment_path(seg_id), start=lo, end=hi, segment_id=seg_id,
            shard_index=shard_index, local_index=local_index)

    def locate(self, index: int) -> PackedIndexLocation:
        """Collection-global record index -> byte range (binary search + 2 reads)."""
        if index < 0:
            index += self.total_records
        if not 0 <= index < self.total_records:
            raise IndexError(
                f"index {index} out of range for packed collection with "
                f"{self.total_records} records"
            )
        pack = self.pack
        pack._ensure_open()
        lo, hi = 0, self.sequence_count
        while lo < hi:
            mid = (lo + hi) >> 1
            if pack._sequence(self.sequence_start + mid)[1] <= index:
                lo = mid + 1
            else:
                hi = mid
        if lo >= self.sequence_count:
            raise ValueError(
                "Corrupt idxpack collection: record index exceeds the final "
                "cumulative shard count"
            )
        return self.locate_in_shard(lo, index - self._cumulative_before(lo))


class IndexPack:
    """
    Read-only pack view.  Construction parses only the catalog and keeps no
    fd/mmap (pickle- and fork-safe); the mmap is established and deep-validated
    on first data access in each process.
    """

    def __init__(self, path, *, expected_layout_hash: Union[str, bytes, None] = None):
        self.path = Path(path)
        self.expected_layout_hash = expected_layout_hash
        self._fh = None
        self._mmap = None
        self._owner_pid = None
        self._identity = None
        self._collections: dict = {}
        self._load_catalog()

    # -- public ------------------------------------------------------------------

    def collection(self, key: Union[bytes, str]) -> PackedIndexCollection:
        """Logical collection view by 32-byte (or hex string) key."""
        if isinstance(key, str):
            key = bytes.fromhex(key)
        entry = self._collections.get(key)
        if entry is None:
            raise KeyError(f"Collection {key.hex()} is not present in index pack {self.path}")
        seq_start, seq_count, total, kind, offsets_required = entry
        return PackedIndexCollection(self, key, seq_start, seq_count, total, kind, offsets_required)

    def verify(self) -> int:
        """CRC32-check EVERY segment's offsets payload; returns the number of
        segments verified. Raises ValueError on the first mismatch."""
        self._ensure_open()
        for seg_id in range(self.num_segments):
            self.verify_segment(seg_id)
        return self.num_segments

    def verify_segment(self, segment_id: int) -> None:
        """CRC32-check one offsets payload (on demand, not at open time)."""
        seg = self._segment(segment_id)
        actual = (
            zlib.crc32(self._mmap[seg.offsets_pos : seg.offsets_pos + seg.offsets_size])
            & 0xFFFFFFFF
        )
        if actual != seg.crc32:
            raise ValueError(
                f"Index-pack CRC mismatch for segment {segment_id} in {self.path}: "
                f"expected={seg.crc32:#x}, actual={actual:#x}"
            )

    def close(self) -> None:
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._owner_pid = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    def __del__(self):
        if hasattr(self, "_mmap"):
            self.close()

    # -- pickling: ship the parsed catalog, never the fd/mmap ---------------------

    _CATALOG_FIELDS = (
        "collection_offset", "num_collections", "sequence_offset", "num_sequences",
        "segment_offset", "num_segments", "strings_offset", "strings_size", "offsets_offset",
        "offsets_size", "layout_hash")

    def __getstate__(self):
        state = {
            "path": self.path, "expected_layout_hash": self.expected_layout_hash,
            "file_identity": self._identity, "collections": self._collections}
        for f in self._CATALOG_FIELDS:
            state[f] = getattr(self, f)
        return state

    def __setstate__(self, state):
        self.path = state["path"]
        self.expected_layout_hash = state["expected_layout_hash"]
        self._fh = self._mmap = self._owner_pid = None
        self._identity = state.get("file_identity")
        self._collections = state["collections"]
        for f in self._CATALOG_FIELDS:
            setattr(self, f, state[f])

    # -- internals ------------------------------------------------------------------

    def _take_identity(self, fileno: int):
        st = os.fstat(fileno)
        identity = (st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns)
        if self._identity is not None and identity != self._identity:
            raise RuntimeError(
                f"Index pack changed after it was opened: {self.path}; "
                "reconstruct the dataset to use the replacement"
            )
        return identity, st.st_size

    def _parse_header(self, buf, file_size: int) -> None:
        fields = _HEADER.unpack_from(buf, 0)
        magic, version, header_size = fields[:3]
        (
            self.collection_offset, self.num_collections, self.sequence_offset, self.num_sequences,
            self.segment_offset, self.num_segments, self.strings_offset, self.strings_size,
            self.offsets_offset, self.offsets_size, self.layout_hash) = fields[3:]
        if magic != _MAGIC:
            raise ValueError(f"Invalid index-pack header magic in {self.path}: {magic!r}")
        if version != _VERSION or header_size != _HEADER_SIZE:
            raise ValueError(
                f"Unsupported index-pack header in {self.path}: "
                f"version={version}, header_size={header_size}"
            )
        spans = {
            "collections": (self.collection_offset, self.num_collections * _COLLECTION.size),
            "sequences": (self.sequence_offset, self.num_sequences * _SEQUENCE.size),
            "segments": (self.segment_offset, self.num_segments * _SEGMENT.size),
            "strings": (self.strings_offset, self.strings_size),
            "offsets": (self.offsets_offset, self.offsets_size)}
        for name, (off, size) in spans.items():
            if off < _HEADER_SIZE or size < 0 or off + size > file_size:
                raise ValueError(
                    f"Index pack has truncated/invalid {name} section: "
                    f"offset={off}, size={size}, file_size={file_size}"
                )
        aligned = self.strings_offset + self.strings_size
        aligned += (-aligned) % _U64.size
        if self.offsets_offset != aligned or self.offsets_offset + self.offsets_size != file_size:
            raise ValueError(
                "Index pack sections overlap, contain gaps, or do not cover "
                "the complete file"
            )
        want = self.expected_layout_hash
        if want is not None:
            if isinstance(want, str):
                want = bytes.fromhex(want)
            if want != self.layout_hash:
                raise ValueError(
                    f"Index-pack layout mismatch for {self.path}: "
                    f"expected={want.hex()}, actual={self.layout_hash.hex()}"
                )

    def _load_catalog(self) -> None:
        """Read the collection directory via pread (no retained fd/mmap)."""
        try:
            fh = self.path.open("rb")
        except FileNotFoundError as ex:
            raise FileNotFoundError(f"Index pack not found: {self.path}") from ex
        with fh:
            fd = fh.fileno()
            identity, file_size = self._take_identity(fd)
            if file_size < _HEADER_SIZE:
                raise ValueError(
                    f"Index pack is truncated before its {_HEADER_SIZE}-byte "
                    f"header: {self.path}"
                )
            self._parse_header(_pread_exact(fd, _HEADER_SIZE, 0), file_size)

            table = _pread_exact(
                fd, self.num_collections * _COLLECTION.size, self.collection_offset)
            found: dict = {}
            next_seq = 0
            for cid in range(self.num_collections):
                row = _ColRow(*_COLLECTION.unpack_from(table, cid * _COLLECTION.size))
                self._check_collection_row(fd, cid, row, found, next_seq)
                kind = _pread_exact(fd, row.kind_len, row.kind_pos).decode("utf-8")
                paths_only = self._resolve_paths_only(fd, cid, row)
                if paths_only and row.total_records != 0:
                    raise ValueError(
                        f"Index pack collection {cid} has an invalid total "
                        f"record count"
                    )
                found[row.key] = (
                    row.seq_start, row.seq_count, row.total_records, kind, not paths_only)
                next_seq += row.seq_count
            if next_seq != self.num_sequences:
                raise ValueError("Index pack contains unreferenced sequence rows")
            self._collections = found
            self._identity = identity

    def _check_collection_row(self, fd, cid, row: _ColRow, found, next_seq) -> None:
        if row.flags & ~_COLLECTION_PATHS_ONLY:
            raise ValueError(f"Index pack collection {cid} has unsupported flags: {row.flags:#x}")
        if row.seq_start != next_seq or row.seq_start + row.seq_count > self.num_sequences:
            raise ValueError(f"Index pack collection {cid} has an invalid sequence range")
        if row.key in found:
            raise ValueError(f"Duplicate collection key in index pack: {row.key.hex()}")
        if (
            row.kind_pos < self.strings_offset
            or row.kind_pos + row.kind_len > self.strings_offset + self.strings_size
        ):
            raise ValueError(f"Index pack collection {cid} kind points outside the strings section")

    def _resolve_paths_only(self, fd, cid, row: _ColRow) -> bool:
        paths_only = bool(row.flags & _COLLECTION_PATHS_ONLY)
        if not row.seq_count:
            return paths_only
        seg_id, _ = _SEQUENCE.unpack(
            _pread_exact(fd, _SEQUENCE.size, self.sequence_offset + row.seq_start * _SEQUENCE.size)
        )
        if seg_id >= self.num_segments:
            raise ValueError(f"Index pack collection {cid} has corrupt sequence metadata")
        seg = _SegRow(
            *_SEGMENT.unpack(
                _pread_exact(fd, _SEGMENT.size, self.segment_offset + seg_id * _SEGMENT.size)
            )
        )
        _, final_total = _SEQUENCE.unpack(
            _pread_exact(
                fd,
                _SEQUENCE.size,
                self.sequence_offset + (row.seq_start + row.seq_count - 1) * _SEQUENCE.size,
            )
        )
        if final_total != row.total_records:
            raise ValueError(
                f"Index pack collection {cid} has corrupt cumulative count for "
                f"its final shard: {final_total} != {row.total_records}"
            )
        return bool(seg.flags & _SEGMENT_PATH_ONLY)

    def _mount(self) -> None:
        """Establish the mmap and run deep segment validation."""
        try:
            self._fh = self.path.open("rb")
        except FileNotFoundError as ex:
            raise FileNotFoundError(f"Index pack not found: {self.path}") from ex
        try:
            identity, file_size = self._take_identity(self._fh.fileno())
        except Exception:
            self._fh.close()
            self._fh = None
            raise
        self._mmap = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._owner_pid = os.getpid()
        self._identity = identity
        try:
            self._parse_header(self._mmap, file_size)
            cursor = self.offsets_offset
            for seg_id in range(self.num_segments):
                seg = self._segment_row(seg_id)
                if seg.flags & ~_SEGMENT_PATH_ONLY:
                    raise ValueError(
                        f"Index pack segment {seg_id} has unsupported flags: "
                        f"{seg.flags:#x}"
                    )
                self._string(seg.path_pos, seg.path_len, label=f"segment {seg_id} path")
                if seg.offsets_count < 1 or seg.offsets_size != seg.offsets_count * _U64.size:
                    raise ValueError(
                        f"Index pack segment {seg_id} has inconsistent "
                        f"offset count/size"
                    )
                if (
                    seg.offsets_pos != cursor
                    or seg.offsets_pos + seg.offsets_size
                    > self.offsets_offset + self.offsets_size
                ):
                    raise ValueError(
                        f"Index pack segment {seg_id} has an invalid offset "
                        f"payload range"
                    )
                if seg.flags & _SEGMENT_PATH_ONLY and (
                    seg.offsets_count != 1 or seg.source_size != 0
                ):
                    raise ValueError(
                        f"Index pack path-only segment {seg_id} contains "
                        f"record metadata"
                    )
                cursor += seg.offsets_size
            if cursor != self.offsets_offset + self.offsets_size:
                raise ValueError("Index pack segment payloads do not cover the offsets section")
        except Exception:
            self.close()
            raise

    def _ensure_open(self) -> None:
        if self._mmap is None or self._owner_pid != os.getpid():
            self.close()
            self._mount()
            _share_index_pack(self)

    def _sequence(self, index: int):
        self._ensure_open()
        if not 0 <= index < self.num_sequences:
            raise IndexError(f"Index-pack sequence index out of range: {index}")
        return _SEQUENCE.unpack_from(self._mmap, self.sequence_offset + index * _SEQUENCE.size)

    def _segment_row(self, index: int) -> _SegRow:
        if not 0 <= index < self.num_segments:
            raise IndexError(f"Index-pack segment index out of range: {index}")
        return _SegRow(
            *_SEGMENT.unpack_from(self._mmap, self.segment_offset + index * _SEGMENT.size)
        )

    def _segment(self, index: int) -> _SegRow:
        self._ensure_open()
        return self._segment_row(index)

    def _segment_path(self, index: int) -> str:
        seg = self._segment(index)
        return self._string(seg.path_pos, seg.path_len, label=f"segment {index} path")

    def _u64(self, position: int) -> int:
        self._ensure_open()
        return _U64.unpack_from(self._mmap, position)[0]

    def _string(self, position: int, length: int, *, label: str) -> str:
        self._ensure_open()
        if (
            position < self.strings_offset
            or position + length > self.strings_offset + self.strings_size
        ):
            raise ValueError(
                f"Index pack {label} points outside the strings section: "
                f"position={position}, length={length}"
            )
        try:
            return self._mmap[position : position + length].decode("utf-8")
        except UnicodeDecodeError as ex:
            raise ValueError(f"Index pack {label} is not valid UTF-8") from ex


# ---------------------------------------------------------------------------
# Per-process pack sharing
# ---------------------------------------------------------------------------
_OPEN_PACKS: "weakref.WeakValueDictionary[str, IndexPack]" = weakref.WeakValueDictionary()
_OPEN_PACKS_PID = os.getpid()


def _pack_registry() -> "weakref.WeakValueDictionary[str, IndexPack]":
    global _OPEN_PACKS_PID
    if os.getpid() != _OPEN_PACKS_PID:
        _OPEN_PACKS.clear()
        _OPEN_PACKS_PID = os.getpid()
    return _OPEN_PACKS


def open_index_pack(path) -> IndexPack:
    """One shared lazy pack view per absolute path per process."""
    registry = _pack_registry()
    key = str(Path(path).absolute())
    pack = registry.get(key)
    if pack is None:
        pack = IndexPack(key)
        registry[key] = pack
    return pack


def _share_index_pack(pack: IndexPack) -> None:
    _pack_registry()[str(pack.path.absolute())] = pack


def _pread_exact(fd: int, size: int, offset: int) -> bytes:
    """Exactly ``size`` bytes at ``offset``; raises EOFError on a short file."""
    parts, got = [], 0
    while got < size:
        piece = os.pread(fd, size - got, offset + got)
        if not piece:
            raise EOFError(
                f"Short positional read: requested {size} bytes at offset "
                f"{offset}, received {got}"
            )
        parts.append(piece)
        got += len(piece)
    return b"".join(parts)


def _fsync_directory(path: Path) -> None:
    if not hasattr(os, "O_DIRECTORY"):
        return
    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECTORY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
