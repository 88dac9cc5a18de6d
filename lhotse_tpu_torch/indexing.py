"""
Sidecar ``.idx`` indexes for constant-time random access and seekable
shuffled iteration (copied from ``lhotse_tpu/indexing.py``): an ``.idx``
file is raw little-endian uint64 byte offsets plus a final EOF sentinel,
written by ``create_jsonl_index`` (one offset per line),
``create_tar_index`` (one offset per Shar data+metadata member pair) and
``create_shar_index`` (every uncompressed JSONL and tar in a directory);
:class:`LazyShuffledRange` is a seed-determined permutation of ``range(n)``
in O(1) memory (a Feistel network with cycle-walking), sliceable into
``(shard_id, num_shards)`` partitions; :class:`IndexedJsonlReader` and
:class:`IndexedTarReader` fetch one record with ``os.pread``.

An index file behind a pipe (``pipe:<command>``) or a URL is read through
``open_best`` and materialised into a temporary cache, as in the JAX
package; where no I/O backend serves it, ``open_best`` raises as the JAX
package's does.
"""
from __future__ import annotations

import hashlib
import io
import os
import tarfile
import tempfile
import threading
import time
from json import JSONDecodeError
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from lhotse_tpu_torch.serialization import decode_json_line, open_best
from lhotse_tpu_torch.utils import Pathlike, is_valid_url

_OFFSET_DTYPE = np.dtype("<u8")
_COMPRESSED_SUFFIXES = {".gz", ".bz2", ".xz", ".lz4", ".zst"}
_TAR_BLOCK_SIZE = 512


def _path_str(path: Pathlike) -> str:
    return str(path)


def _is_pipe_path(path: Pathlike) -> bool:
    return _path_str(path).startswith("pipe:") or _path_str(path) == "-"


def _as_local_path(path: Pathlike) -> Optional[Path]:
    s = _path_str(path)
    if _is_pipe_path(s) or is_valid_url(s):
        return None
    return Path(s)


def _is_compressed_path(path: Pathlike) -> bool:
    return any(_path_str(path).endswith(sfx) for sfx in _COMPRESSED_SUFFIXES)


def indexed_path_kind(path: Pathlike) -> Optional[str]:
    s = _path_str(path)
    if s.endswith(".jsonl"):
        return "jsonl"
    if s.endswith(".tar"):
        return "tar"
    return None


def supports_indexed_access(path: Pathlike, *, kind: Optional[str] = None) -> bool:
    if _is_pipe_path(path) or _is_compressed_path(path):
        return False
    actual = indexed_path_kind(path)
    if actual is None:
        return False
    return kind is None or actual == kind


def validate_indexed_access(
    path: Pathlike, kind: Optional[str] = None, context: str = "indexed access") -> None:
    if not supports_indexed_access(path, kind=kind):
        raise RuntimeError(
            f"{context} requires an uncompressed "
            f"{'.' + kind if kind else '.jsonl/.tar'} file; got: {path}"
        )


def index_file_path(data_path: Pathlike, indexes_root: Optional[Pathlike] = None) -> Path:
    """
    Conventional sidecar location: ``<data_path>.idx`` — or, when
    ``indexes_root`` is given, the same path mirrored under that root
    (URL schemes are stripped so remote paths can nest locally).
    """
    if indexes_root is None:
        return Path(_path_str(data_path) + ".idx")
    s = _path_str(data_path)
    if "://" in s:
        s = s.split("://", 1)[1]
    return Path(indexes_root) / (s.lstrip("/") + ".idx")


# Alias used by the serialization layer.
default_index_path = index_file_path


def index_exists(data_path: Pathlike, index_path: Optional[Pathlike] = None) -> bool:
    """True when an ``.idx`` exists and is usable (nonzero, uint64-aligned)."""
    idx_path = index_path if index_path is not None else index_file_path(data_path)
    local_path = _as_local_path(idx_path)
    if local_path is not None:
        return _is_valid_index_file(local_path)
    try:
        with open_best(idx_path, "rb") as f:
            f.read(1)
        return True
    except Exception:
        return False


def _is_valid_index_file(path: Path) -> bool:
    try:
        size = path.stat().st_size
    except FileNotFoundError:
        return False
    return size >= _OFFSET_DTYPE.itemsize and size % _OFFSET_DTYPE.itemsize == 0


def _write_index(offsets: list, path: Pathlike) -> None:
    """Atomically write offsets (stage-and-rename) so racing readers never
    observe a half-written index."""
    payload = np.array(offsets, dtype=_OFFSET_DTYPE).tobytes()
    local_path = _as_local_path(path)
    if local_path is None:
        with open_best(path, "wb") as f:
            f.write(payload)
        return
    local_path.parent.mkdir(parents=True, exist_ok=True)
    stage_name = f"{local_path.name}.tmp.{os.getpid()}.{time.monotonic_ns()}"
    stage = local_path.with_name(stage_name)
    try:
        stage.write_bytes(payload)
        os.replace(stage, local_path)
    finally:
        stage.unlink(missing_ok=True)


def _remote_index_cache_dir() -> Path:
    return Path(tempfile.gettempdir()) / "lhotse-tpu-torch-index-cache"


def _remote_index_cache_path(idx_path: Pathlike) -> Path:
    digest = hashlib.sha256(_path_str(idx_path).encode("utf-8")).hexdigest()
    return _remote_index_cache_dir() / f"{digest}.idx"


def _materialize_remote_index(idx_path: Pathlike) -> Path:
    cache_path = _remote_index_cache_path(idx_path)
    if _is_valid_index_file(cache_path):
        return cache_path
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(
        prefix=f"{cache_path.name}.", suffix=".tmp", dir=str(cache_path.parent))
    tmp_path = Path(tmp_name)
    try:
        with open_best(idx_path, "rb") as src, os.fdopen(fd, "wb") as dst:
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                dst.write(chunk)
            dst.flush()
            os.fsync(dst.fileno())
        if not _is_valid_index_file(tmp_path):
            raise FileNotFoundError(f"Index file not found, empty, or invalid: {idx_path}")
        os.replace(tmp_path, cache_path)
    finally:
        if tmp_path.exists():
            tmp_path.unlink()
    return cache_path


def read_index(idx_path: Pathlike) -> np.ndarray:
    """Read a ``.idx`` file into a uint64 offsets array (last = sentinel)."""
    local_path = _as_local_path(idx_path)
    if local_path is not None:
        if not local_path.is_file():
            raise FileNotFoundError(f"Index file not found: {local_path}")
        return np.fromfile(local_path, dtype=_OFFSET_DTYPE)
    cache_path = _materialize_remote_index(idx_path)
    return np.fromfile(cache_path, dtype=_OFFSET_DTYPE)


def _assert_uncompressed(path: Pathlike, kind: str) -> None:
    if _is_compressed_path(path):
        raise RuntimeError(
            f"Cannot create an index for a compressed {kind} file: {path}. "
            f"Only uncompressed files are supported."
        )


def create_jsonl_index(jsonl_path: Pathlike, output_path: Optional[Pathlike] = None) -> Path:
    """Build a line-offset index for an uncompressed JSONL file."""
    _assert_uncompressed(jsonl_path, "JSONL")
    offsets = []
    pos = 0
    with open_best(jsonl_path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                break
            offsets.append(pos)
            pos += len(line)
        offsets.append(pos)
    idx_path = output_path if output_path is not None else index_file_path(jsonl_path)
    _write_index(offsets, idx_path)
    return idx_path


def read_tar_member_at(fh, offset: int):
    """Read one tar member's header + payload at ``offset`` from an open
    binary file handle, returning ``(data_bytes, member_path, tar_info)``.

    ``data_bytes`` is ``None`` for ``.nodata``/``.nometa`` placeholder
    members. The offset must point at a regular member's 512-byte header —
    no validation or skipping of non-regular members is performed.
    """
    fh.seek(offset)
    header = fh.read(_TAR_BLOCK_SIZE)
    if len(header) < _TAR_BLOCK_SIZE:
        raise RuntimeError(f"Unexpected EOF reading tar header at offset {offset}")
    info = tarfile.TarInfo.frombuf(header, tarfile.ENCODING, "surrogateescape")
    path = Path(info.name)
    if path.suffix in (".nodata", ".nometa"):
        return None, path, info
    return fh.read(info.size), path, info


def create_tar_index(tar_path: Pathlike, output_path: Optional[Pathlike] = None) -> Path:
    """
    Build an index over a Shar tar archive, one entry per sample *pair*
    (data member + metadata member — the Shar convention).
    """
    _assert_uncompressed(tar_path, "tar")
    offsets = []
    with open_best(tar_path, "rb") as f:
        with tarfile.open(fileobj=f, mode="r|") as tf:
            # Shar convention: members alternate data, metadata — record the
            # offset of every pair's data member.
            for k, member in enumerate(tf):
                if k % 2 == 0:
                    offsets.append(member.offset)
            total_members = k + 1 if offsets else 0
            sentinel_from_tarfile = tf.offset
        if total_members % 2:
            raise RuntimeError(
                f"Expected an even number of tar members (data+meta pairs) "
                f"in {tar_path}, got {total_members}."
            )
        try:
            sentinel = f.tell()
        except (io.UnsupportedOperation, OSError, AttributeError):
            sentinel = sentinel_from_tarfile
        offsets.append(sentinel)
    idx_path = output_path if output_path is not None else index_file_path(tar_path)
    _write_index(offsets, idx_path)
    return idx_path


def create_shar_index(shar_dir: Pathlike, output_dir: Optional[Pathlike] = None) -> None:
    """Create indexes for all JSONL/tar files in a Shar directory
    (compressed files are skipped)."""
    shar_dir = Path(shar_dir)
    for p in sorted(shar_dir.iterdir()):
        out = None
        if output_dir is not None:
            out = Path(output_dir) / (p.name + ".idx")
        if p.suffix == ".jsonl":
            create_jsonl_index(p, output_path=out)
        elif p.suffix == ".tar":
            create_tar_index(p, output_path=out)


#################################################
# LazyShuffledRange — seekable pseudo-random permutation
#################################################


def _mix64(h: int) -> int:
    """splitmix64-style finalizer."""
    h &= 0xFFFFFFFFFFFFFFFF
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 31
    return h


class LazyShuffledRange:
    """
    An O(1)-memory lazy permutation of ``range(n)`` determined by ``seed``:
    a balanced Feistel network with cycle-walking for non-power-of-two sizes.
    With ``num_shards > 1`` it yields only the slice of the permutation at
    logical offsets ``shard_id, shard_id + num_shards, ...`` — the single
    primitive for DP-rank × worker data partitioning with item-level shuffle.
    Checkpointable by position alone.
    """

    NUM_ROUNDS = 6

    def __init__(self, n: int, seed: int, shard_id: int = 0, num_shards: int = 1) -> None:
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if not (0 <= shard_id < num_shards):
            raise ValueError(f"shard_id must be in [0, num_shards={num_shards}), got {shard_id}")
        self.n = n
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._pos = 0
        if n <= 1:
            self._half_bits = 1
        else:
            total_bits = max(2, (n - 1).bit_length())
            if total_bits % 2:
                total_bits += 1
            self._half_bits = total_bits // 2
        self._half_mask = (1 << self._half_bits) - 1
        # Derive round keys deterministically from the seed.
        self._round_keys = [
            _mix64((seed & 0xFFFFFFFFFFFFFFFF) ^ _mix64(r + 0x9E3779B97F4A7C15))
            for r in range(self.NUM_ROUNDS)
        ]

    def __len__(self) -> int:
        if self.n <= self.shard_id:
            return 0
        return (self.n - self.shard_id + self.num_shards - 1) // self.num_shards

    def __getitem__(self, idx: int) -> int:
        shard_len = len(self)
        if idx < 0:
            idx += shard_len
        if idx < 0 or idx >= shard_len:
            raise IndexError(
                f"index {idx} out of range for LazyShuffledRange(n={self.n}, "
                f"shard_id={self.shard_id}, num_shards={self.num_shards})"
            )
        return self._permute(self.shard_id + idx * self.num_shards)

    def __iter__(self) -> "LazyShuffledRange":
        return self

    def __next__(self) -> int:
        logical = self.shard_id + self._pos * self.num_shards
        if logical >= self.n:
            raise StopIteration
        val = self._permute(logical)
        self._pos += 1
        return val

    def reset(self) -> None:
        self._pos = 0

    def state_dict(self) -> dict:
        return {
            "n": self.n, "seed": self.seed, "shard_id": self.shard_id,
            "num_shards": self.num_shards, "pos": self._pos}

    def load_state_dict(self, sd: dict) -> None:
        saved_shard_id = sd.get("shard_id", 0)
        saved_num_shards = sd.get("num_shards", 1)
        if (
            sd["n"] != self.n
            or sd["seed"] != self.seed
            or saved_shard_id != self.shard_id
            or saved_num_shards != self.num_shards
        ):
            raise ValueError(
                f"LazyShuffledRange state mismatch: expected n={self.n}, seed={self.seed}, "
                f"shard_id={self.shard_id}, num_shards={self.num_shards}; got n={sd['n']}, "
                f"seed={sd['seed']}, shard_id={saved_shard_id}, num_shards={saved_num_shards}. "
                f"Resuming with a different DP/worker topology is not supported."
            )
        self._pos = sd["pos"]

    def _round_fn(self, value: int, key: int) -> int:
        return _mix64(value ^ key) & self._half_mask

    def _feistel(self, x: int) -> int:
        left = (x >> self._half_bits) & self._half_mask
        right = x & self._half_mask
        for key in self._round_keys:
            left, right = right, left ^ self._round_fn(right, key)
        return (left << self._half_bits) | right

    def _permute(self, idx: int) -> int:
        x = idx
        while True:
            x = self._feistel(x)
            if x < self.n:
                return x


def _open_for_indexed_read(path: Pathlike):
    """Open ``path`` with seek support (local binary file)."""
    return open_best(path, "rb")


class _IndexedReaderBase:
    """
    Shared machinery of the indexed pread readers: resolves/creates the .idx
    sidecar, lazily (re)opens the data file per process (fork safety), and
    keeps open handles out of pickles.
    """

    _KIND: str  # "jsonl" | "tar"

    def __init__(
        self, path: Pathlike, auto_create_index: bool = True, index_path: Optional[Pathlike] = None,
    ) -> None:
        validate_indexed_access(path, kind=self._KIND, context=type(self).__name__)
        self.path, self.index_path = path, index_path
        self._fh, self._fh_pid = None, None
        self._fh_lock = threading.Lock()
        idx_path = index_path if index_path is not None else index_file_path(path)
        self._resolved_index_path = idx_path
        if not index_exists(path, index_path=idx_path):
            if not auto_create_index:
                raise FileNotFoundError(
                    f"Index file not found: {idx_path}. Use create_{self._KIND}_index() "
                    f"to build it, or set auto_create_index=True."
                )
            builder = create_jsonl_index if self._KIND == "jsonl" else create_tar_index
            builder(path, output_path=idx_path)
        self._offsets = read_index(idx_path)

    def _ensure_open(self):
        pid = os.getpid()
        if self._fh is not None and self._fh_pid == pid:
            return
        with self._fh_lock:
            if self._fh is not None and self._fh_pid == pid:
                return  # another thread won the reopen race
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
            self._fh = _open_for_indexed_read(self.path)
            self._fh_pid = pid

    def __del__(self):
        self.close()

    def close(self):
        # A reader whose path failed validation never set its handle.
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
        self._fh, self._fh_pid = None, None

    def __getstate__(self):
        state = {**self.__dict__, "_fh": None, "_fh_pid": None}
        state.pop("_fh_lock", None)  # locks are not picklable
        return state

    def __setstate__(self, state):
        state.setdefault("_fh_pid", None)
        self.__dict__.update(state)
        self._fh_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def _pread(self, start: int, end: int) -> bytes:
        # Thread-safe ranged read. Local files use true positionless
        # os.pread (no shared seek pointer, no serialization across
        # threads); streams without a file descriptor fall back to a
        # lock-guarded seek+read. The DataLoader's thread-pool assembly mode
        # makes concurrent reads through ONE reader a supported pattern.
        self._ensure_open()
        fh = self._fh
        try:
            fd = fh.fileno()
        except (AttributeError, OSError, ValueError):
            fd = None
        if fd is not None and hasattr(os, "pread"):
            return os.pread(fd, end - start, start)
        with self._fh_lock:
            fh.seek(start)
            return fh.read(end - start)


class IndexedJsonlReader(_IndexedReaderBase):
    """
    Random-access reader for an uncompressed JSONL file: each ``__getitem__``
    is one seek + range-read + JSON parse. Auto-creates the index by default.
    File handles are reopened per-process (fork safety) and excluded from
    pickling.
    """

    _KIND = "jsonl"

    def __getitem__(self, idx: int) -> dict:
        if idx < 0:
            idx += len(self)
        if idx < 0 or idx >= len(self):
            raise IndexError(
                f"index {idx} out of range for IndexedJsonlReader with {len(self)} lines"
            )
        start, end = int(self._offsets[idx]), int(self._offsets[idx + 1])
        decoded = self._pread(start, end).decode("utf-8")
        try:
            return decode_json_line(decoded)
        except JSONDecodeError as ex:
            preview = decoded[:120].replace("\n", "\\n")
            raise JSONDecodeError(
                f"{ex.msg} while decoding indexed JSONL record path={self.path!r} " f"idx={idx} byte_range=[{start}, {end}) preview={preview!r}",
                ex.doc, ex.pos) from ex

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _ceil_block(size: int) -> int:
    return (size + _TAR_BLOCK_SIZE - 1) // _TAR_BLOCK_SIZE * _TAR_BLOCK_SIZE


class IndexedTarReader(_IndexedReaderBase):
    """
    Random-access reader for an uncompressed Shar tar archive. Each sample is
    a pair of consecutive members (data + metadata); ``__getitem__`` seeks to
    the pair, reads both, and returns ``(manifest_or_none, data_path,
    data_byte_range)`` where the byte range covers the data member's payload
    (for shar_ptr construction).
    """

    _KIND = "tar"

    def _read_header(self, offset: int):
        # Thread-safe: ranged read via the base _pread (os.pread on files).
        header = self._pread(offset, offset + _TAR_BLOCK_SIZE)
        if len(header) < _TAR_BLOCK_SIZE or header == b"\0" * _TAR_BLOCK_SIZE:
            raise EOFError(f"Unexpected end of tar archive at offset {offset}")
        info = tarfile.TarInfo.frombuf(header, tarfile.ENCODING, "surrogateescape")
        return info

    def member_byte_range(self, idx: int) -> Tuple[int, int]:
        """Byte range [start, end) of the *data* member's payload for sample idx."""
        self._ensure_open()
        offset = int(self._offsets[idx])
        info = self._read_header(offset)
        start = offset + _TAR_BLOCK_SIZE
        return start, start + info.size

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        if idx < 0 or idx >= len(self):
            raise IndexError(
                f"index {idx} out of range for IndexedTarReader with {len(self)} samples"
            )
        self._ensure_open()
        offset = int(self._offsets[idx])
        info = self._read_header(offset)
        data_start = offset + _TAR_BLOCK_SIZE
        data = self._pread(data_start, data_start + info.size)
        next_offset = offset + _TAR_BLOCK_SIZE + _ceil_block(info.size)
        meta_info = self._read_header(next_offset)
        meta_start = next_offset + _TAR_BLOCK_SIZE
        meta_bytes = self._pread(meta_start, meta_start + meta_info.size)
        from lhotse_tpu_torch.shar.readers.tar import parse_tar_sample

        return parse_tar_sample(data, info.name, meta_bytes, meta_info.name)
