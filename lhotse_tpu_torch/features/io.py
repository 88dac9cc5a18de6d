"""
Feature/array storage backends keyed by ``storage_type`` strings (copied
from ``lhotse_tpu/features/io.py``): the registry, ``FeaturesWriter.store_array``,
``FileIO``, the per-file backends ``lilcom_files`` and ``numpy_files``, the
flat-binary chunky archive ``lilcom_chunky`` (the default: a ``.lca`` file
with comma-separated chunk offsets as the key and partial reads per chunk,
through a per-process cache of read fds) and the in-memory
``memory_lilcom``/``memory_raw``/``memory_npy``. Env override:
``LHOTSE_TPU_FEATURES_STORAGE_BACKEND`` (``LHOTSE_FEATURES_STORAGE_BACKEND``
is honoured too).

The compression codec is the LTC1 codec (:mod:`lhotse_tpu_torch.codecs`).
The HDF5 backends, ``kaldiio``, ``lilcom_url`` and the Shar readers are not
ported: :func:`get_reader` and :func:`get_writer` raise for their names.
"""
from __future__ import annotations

import os
import pickle
from abc import ABCMeta, abstractmethod
from contextlib import contextmanager
from functools import lru_cache
from io import BytesIO
from math import ceil, floor
from pathlib import Path
from typing import Dict, Generator, List, Optional, Type, Union

import numpy as np

from lhotse_tpu_torch.array import Array, TemporalArray
from lhotse_tpu_torch.caching import dynamic_lru_cache
from lhotse_tpu_torch.codecs import compress as ltc_compress
from lhotse_tpu_torch.codecs import decompress as ltc_decompress
from lhotse_tpu_torch.codecs import decompress_concat as ltc_decompress_concat
from lhotse_tpu_torch.serialization import open_best
from lhotse_tpu_torch.utils import Pathlike, Seconds, is_valid_url, not_ported


class FeaturesWriter(metaclass=ABCMeta):
    """
    Interface for storing numpy arrays in a storage backend (files, archives,
    memory, object stores). Subclasses define ``name``, ``storage_path``, and
    ``write(key, value) -> storage_key``. Usable as a context manager.
    """

    name = property(abstractmethod(lambda self: ...))
    storage_path = property(abstractmethod(lambda self: ...))

    @abstractmethod
    def write(self, key: str, value: np.ndarray) -> str:
        ...

    def store_array(
        self, key: str, value: np.ndarray, frame_shift: Optional[Seconds] = None,
        temporal_dim: Optional[int] = None, start: Seconds = 0) -> Union[Array, TemporalArray]:
        """
        Store a numpy array and return an :class:`Array` (or
        :class:`TemporalArray` when frame_shift/temporal_dim are given)
        manifest describing how to retrieve it.
        """
        temporal = (frame_shift is not None, temporal_dim is not None)
        assert temporal in ((True, True), (False, False)), (
            "frame_shift and temporal_dim have to be both None or both set "
            f"(got frame_shift={frame_shift}, temporal_dim={temporal_dim})."
        )
        array = Array(
            storage_type=self.name, storage_path=self.storage_path,
            storage_key=self.write(key, value), shape=list(value.shape))
        if not all(temporal):
            return array
        return TemporalArray(
            array=array, temporal_dim=temporal_dim, frame_shift=frame_shift, start=start)

    def flush(self) -> None:
        """Push any buffered writes to durable storage without closing.

        After this returns, every manifest handed out by :meth:`write` so far
        must be loadable by the matching reader. Writers that buffer (e.g.
        the chunky archive) override this; stateless writers need not.
        """
        ...

    def __enter__(self):
        return self

    def __exit__(self, *args, **kwargs):
        ...


class FeaturesReader(metaclass=ABCMeta):
    """
    Interface for loading numpy arrays from a storage backend: ``read(key,
    left_offset_frames, right_offset_frames)`` with the time dim first.
    """

    @property
    @abstractmethod
    def name(self) -> str:
        ...

    @abstractmethod
    def read(
        self, key: str, left_offset_frames: int = 0, right_offset_frames: Optional[int] = None,
    ) -> np.ndarray:
        ...


READER_BACKENDS: Dict[str, Type[FeaturesReader]] = {}
WRITER_BACKENDS: Dict[str, Type[FeaturesWriter]] = {}

def available_storage_backends() -> List[str]:
    return sorted(set(READER_BACKENDS).intersection(WRITER_BACKENDS))


def default_features_storage_backend_name() -> str:
    maybe_backend = os.environ.get(
        "LHOTSE_TPU_FEATURES_STORAGE_BACKEND"
    ) or os.environ.get("LHOTSE_FEATURES_STORAGE_BACKEND")
    if maybe_backend is not None:
        available = available_storage_backends()
        assert maybe_backend in available, (
            f"The requested default feature storage backend {maybe_backend!r} is "
            f"unavailable. Available choices: {available}"
        )
        return maybe_backend
    return "lilcom_chunky"


def default_features_storage_backend() -> Type["FeaturesWriter"]:
    writer = get_writer(default_features_storage_backend_name())
    assert writer is not None
    return writer


def register_reader(cls):
    READER_BACKENDS[cls.name] = cls
    return cls


def register_writer(cls):
    WRITER_BACKENDS[cls.name] = cls
    return cls


NOT_PORTED_STORAGE_BACKENDS = {
    "chunked_lilcom_hdf5", "lilcom_hdf5", "numpy_hdf5", "kaldiio", "lilcom_url", "shar_ptr_array",
    "shar"}


def get_reader(name: str) -> Type[FeaturesReader]:
    if name in NOT_PORTED_STORAGE_BACKENDS:
        raise not_ported(f"The {name!r} feature storage backend")
    if name not in READER_BACKENDS:
        raise KeyError(
            f"Unknown feature storage backend: '{name}'. "
            f"Available readers: {sorted(READER_BACKENDS)}"
        )
    return READER_BACKENDS[name]


def get_writer(name: str) -> Type[FeaturesWriter]:
    if name in NOT_PORTED_STORAGE_BACKENDS:
        raise not_ported(f"The {name!r} feature storage backend")
    if name not in WRITER_BACKENDS:
        raise KeyError(
            f"Unknown feature storage backend: '{name}'. "
            f"Available writers: {sorted(WRITER_BACKENDS)}"
        )
    return WRITER_BACKENDS[name]




def is_in_memory(storage_type: str) -> bool:
    return "memory" in storage_type


def get_memory_writer(name: str):
    assert "memory" in name
    return get_writer(name)


class FileIO:
    """
    Open per-key file objects in a directory on local disk or under a URL
    prefix (reference: io.py:340). With ``add_subdir=True``, local writes go
    into a 3-letter-prefix subdirectory to avoid giant flat directories.
    """

    def __init__(self, storage_path: Pathlike):
        self.storage_path = str(storage_path)
        self.is_url = is_valid_url(storage_path)
        if self.is_url and self.storage_path.endswith("/"):
            self.storage_path = self.storage_path[:-1]

    def _read_path(self, key: str) -> str:
        if key.startswith("/") and self.storage_path:
            key = key[1:]
        return f"{self.storage_path}/{key}"

    def _write_path(self, key: str, add_subdir: bool):
        if self.is_url:
            return f"{self.storage_path}/{key.lstrip('/')}"
        root = Path(self.storage_path)
        root.mkdir(exist_ok=True, parents=True)
        if not add_subdir:
            return root / key
        shard_dir = root / key[:3]
        shard_dir.mkdir(exist_ok=True)
        return shard_dir / key

    @contextmanager
    def open_fileobj(
        self, key: str, mode: str, add_subdir: bool = False) -> Generator[tuple, None, None]:
        assert not ("r" in mode and "w" in mode)
        if "r" in mode:
            path = self._read_path(key)
            with open_best(path, "rb") as f:
                yield f, path
        elif "w" in mode:
            path = self._write_path(key, add_subdir)
            with open_best(path, "wb") as f:
                yield f, path
        else:
            raise ValueError(f"Unsupported file mode (missing r or w): '{mode}'")


#################################################
# Compressed per-file storage
#################################################


class _PerFileReader(FeaturesReader):
    """Per-key files under a directory/URL prefix; subclasses set _decode."""

    def __init__(self, storage_path: Pathlike, *args, **kwargs):
        self.io = FileIO(storage_path)

    @dynamic_lru_cache
    def read(
        self, key: str, left_offset_frames: int = 0, right_offset_frames: Optional[int] = None,
    ) -> np.ndarray:
        with self.io.open_fileobj(key, mode="r") as (f, _):
            arr = self._decode(f)
        return arr[left_offset_frames:right_offset_frames]


class _PerFileWriter(FeaturesWriter):
    """Per-key files under a directory/URL prefix; subclasses set _ext and
    _encode. Local writes shard into 3-letter-prefix subdirectories."""

    _ext: str

    def __init__(self, storage_path: Pathlike, *args, **kwargs):
        self.io = FileIO(storage_path)

    storage_path = property(lambda self: self.io.storage_path)

    def write(self, key: str, value: np.ndarray) -> str:
        if not key.endswith(self._ext):
            key = key + self._ext
        with self.io.open_fileobj(key, "w", add_subdir=True) as (f, out_path):
            self._encode(f, value)
            if not self.io.is_url:
                key = "/".join(Path(out_path).parts[-2:])
        return key


@register_reader
class LilcomFilesReader(_PerFileReader):
    """Reads compressed ``.llc`` files from a directory or object store."""

    name = "lilcom_files"

    def _decode(self, f) -> np.ndarray:
        return ltc_decompress(f.read())


@register_writer
class LilcomFilesWriter(_PerFileWriter):
    """Writes compressed ``.llc`` files into a directory or object store."""

    name = "lilcom_files"
    _ext = ".llc"

    def __init__(self, storage_path: Pathlike, tick_power: int = -5, *args, **kwargs):
        super().__init__(storage_path)
        self.tick_power = tick_power

    def _encode(self, f, value: np.ndarray) -> None:
        f.write(ltc_compress(value, tick_power=self.tick_power))


#################################################
# Non-compressed per-file numpy storage
#################################################


@register_reader
class NumpyFilesReader(_PerFileReader):
    """Reads plain ``.npy`` files from a directory or object store."""

    name = "numpy_files"

    def _decode(self, f) -> np.ndarray:
        return np.load(f, allow_pickle=False)


@register_writer
class NumpyFilesWriter(_PerFileWriter):
    """Writes plain ``.npy`` files into a directory or object store."""

    name = "numpy_files"
    _ext = ".npy"

    def _encode(self, f, value: np.ndarray) -> None:
        np.save(f, value, allow_pickle=False)



#################################################
# Flat-binary archive read fds
#################################################


@lru_cache(maxsize=None)
def _lookup_flat_fd(storage_path: str, _pid: int) -> int:
    """Global cache of raw read fds for flat-binary archives (.lca), keyed by
    (path, pid) so forked workers never share an inherited descriptor's
    cache entry across a reopen. Reads go through ``os.pread`` (stateless
    offset), so one fd is safely shared across loader threads."""
    return os.open(storage_path, os.O_RDONLY)


_OPEN_FLAT_FDS: set = set()


def close_cached_file_handles() -> None:
    # lru_cache doesn't expose its entries; fds are tracked on the side.
    for fd in list(_OPEN_FLAT_FDS):
        try:
            os.close(fd)
        except OSError:
            pass
    _OPEN_FLAT_FDS.clear()
    _lookup_flat_fd.cache_clear()


def _flat_pread(storage_path: str, offset: int, size: int) -> bytes:
    fd = _lookup_flat_fd(str(storage_path), os.getpid())
    _OPEN_FLAT_FDS.add(fd)
    return os.pread(fd, size, offset)


#################################################
# Flat-binary chunky storage (".lca" — the primary format)
#################################################

CHUNKY_FORMAT_CHUNK_SIZE = 500


@register_reader
class LilcomChunkyReader(FeaturesReader):
    """
    Reads compressed chunks from a flat binary ``.lca`` file. The key is a
    comma-separated offsets list: the first number is the absolute offset of
    the array, the rest are per-chunk sizes (relative offsets). Only the
    chunks covering the requested frame range are read and decoded
    (reference: io.py:914-980).
    """

    name = "lilcom_chunky"
    CHUNK_SIZE = CHUNKY_FORMAT_CHUNK_SIZE

    def __init__(self, storage_path: Pathlike, *args, **kwargs):
        self.storage_path = storage_path

    @dynamic_lru_cache
    def read(
        self, key: str, left_offset_frames: int = 0, right_offset_frames: Optional[int] = None,
    ) -> np.ndarray:
        left_chunk_idx = floor(left_offset_frames / self.CHUNK_SIZE)
        if right_offset_frames is not None:
            # +1 to include the end of the last chunk.
            right_chunk_idx = ceil(right_offset_frames / self.CHUNK_SIZE) + 1
        else:
            right_chunk_idx = None

        chunk_offsets = np.cumsum(list(map(int, key.split(","))))
        chunk_offsets = chunk_offsets[left_chunk_idx:right_chunk_idx]

        arr = None
        if len(chunk_offsets) >= 2:
            # Chunks are laid out back-to-back in the .lca file: one read
            # covers the whole range, one native call decodes every chunk
            # straight into the output (codecs.decompress_concat).
            sizes = np.diff(chunk_offsets)
            # One stateless pread on a cached fd: no per-read open() and no
            # seek state to race between loader threads.
            blob = _flat_pread(
                self.storage_path,
                int(chunk_offsets[0]),
                int(chunk_offsets[-1] - chunk_offsets[0]),
            )
            arr = ltc_decompress_concat(
                blob, sizes, max_rows=self.CHUNK_SIZE * len(sizes))
            if arr is None:  # non-LTC1 payload or no native codec
                pos = 0
                decompressed = []
                for size in sizes:
                    decompressed.append(ltc_decompress(blob[pos : pos + int(size)]))
                    pos += int(size)
                arr = (
                    np.concatenate(decompressed, axis=0)
                    if decompressed
                    else np.array([])
                )
        if arr is None:
            arr = np.array([])

        shift = self.CHUNK_SIZE * left_chunk_idx
        right = right_offset_frames - shift if right_offset_frames is not None else None
        return arr[left_offset_frames - shift : right]


@register_writer
class LilcomChunkyWriter(FeaturesWriter):
    """
    Writes compressed chunks to a flat binary ``.lca`` ("chunky archive")
    file, appending sequentially; keys encode absolute + relative offsets
    (reference: io.py:982-1060).
    """

    name = "lilcom_chunky"
    CHUNK_SIZE = CHUNKY_FORMAT_CHUNK_SIZE

    def __init__(
        self, storage_path: Pathlike, tick_power: int = -5, mode: str = "wb", *args, **kwargs):
        if "b" not in mode:
            mode = mode + "b"
        assert mode in ("wb", "ab")
        p = Path(storage_path)
        self.storage_path_ = p.with_suffix(p.suffix + ".lca" if p.suffix != ".lca" else ".lca")
        self.tick_power = tick_power
        self.file = open(self.storage_path, mode=mode)
        self.curr_offset = self.file.tell()

    @property
    def storage_path(self) -> str:
        return str(self.storage_path_)

    def write(self, key: str, value: np.ndarray) -> str:
        from lhotse_tpu_torch.features.compression import lilcom_compress_chunked

        serialized_feats = lilcom_compress_chunked(
            value, tick_power=self.tick_power, chunk_size=self.CHUNK_SIZE)
        offsets = [self.curr_offset]
        for feat in serialized_feats:
            nbytes = self.file.write(feat)
            offsets.append(nbytes)
            self.curr_offset += nbytes
        return ",".join(map(str, offsets))

    def flush(self) -> None:
        self.file.flush()

    def close(self) -> None:
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()


#################################################
# In-memory storage
#################################################


@register_reader
class MemoryLilcomReader(FeaturesReader):
    """Decompresses a compressed blob attached to the manifest."""

    name = "memory_lilcom"

    def __init__(self, *args, **kwargs):
        pass

    @dynamic_lru_cache
    def read(
        self, raw_data: bytes, left_offset_frames: int = 0,
        right_offset_frames: Optional[int] = None) -> np.ndarray:
        arr = ltc_decompress(raw_data)
        return arr[left_offset_frames:right_offset_frames]


@register_writer
class MemoryLilcomWriter(FeaturesWriter):
    """Compresses arrays into blobs attached to the manifest."""

    name = "memory_lilcom"

    def __init__(self, *args, lilcom_tick_power: int = -5, **kwargs) -> None:
        self.lilcom_tick_power = lilcom_tick_power

    @property
    def storage_path(self) -> None:
        return None

    def write(self, key: str, value: np.ndarray) -> bytes:
        assert np.issubdtype(value.dtype, np.floating), (
            "Lossy compression supports only floating-point arrays."
        )
        return ltc_compress(value, tick_power=self.lilcom_tick_power)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        pass


@register_reader
class MemoryRawReader(FeaturesReader):
    """Unpickles an array blob attached to the manifest."""

    name = "memory_raw"

    def __init__(self, *args, **kwargs):
        pass

    @dynamic_lru_cache
    def read(
        self, raw_data: bytes, left_offset_frames: int = 0,
        right_offset_frames: Optional[int] = None) -> np.ndarray:
        arr = pickle.loads(raw_data)
        return arr[left_offset_frames:right_offset_frames]


@register_writer
class MemoryRawWriter(FeaturesWriter):
    """Pickles arrays into blobs attached to the manifest."""

    name = "memory_raw"

    def __init__(self, *args, **kwargs):
        pass

    storage_path = property(lambda self: None)

    def write(self, key: str, value: np.ndarray) -> bytes:
        return pickle.dumps(value)

    def close(self) -> None:
        pass


@register_reader
class MemoryNpyReader(FeaturesReader):
    """Reads NPY-format bytes attached to the manifest."""

    name = "memory_npy"

    def __init__(self, *args, **kwargs):
        pass

    @dynamic_lru_cache
    def read(
        self, raw_data: bytes, left_offset_frames: int = 0,
        right_offset_frames: Optional[int] = None) -> np.ndarray:
        arr = np.load(BytesIO(raw_data))
        return arr[left_offset_frames:right_offset_frames]


@register_writer
class MemoryNpyWriter(FeaturesWriter):
    """Writes NPY-format bytes attached to the manifest."""

    name = "memory_npy"

    def __init__(self, *args, **kwargs):
        pass

    @property
    def storage_path(self) -> None:
        return None

    def write(self, key: str, value: np.ndarray) -> bytes:
        stream = BytesIO()
        np.save(stream, value, allow_pickle=False)
        return stream.getvalue()

    def close(self) -> None:
        pass
