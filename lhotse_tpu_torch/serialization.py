"""
Manifest (de)serialization and the pluggable I/O backends (copied from
``lhotse_tpu/serialization.py``): ``open_best`` over ``-`` (stdin or
stdout), ``pipe:<command>`` (a shell subprocess), a member of a tar
archive addressed as ``/data/shard-0.tar/utt.flac`` (``TarAsDirBackend``),
URLs through the optional ``smart_open``, ``aistore`` and
``multistorageclient`` packages (each backend is in the chain only where
its package imports, and raises the JAX package's error where it does
not), and plain and gzipped files; ``set_current_io_backend``,
``io_backend`` and the ``LHOTSE_TPU_IO_BACKEND`` / ``LHOTSE_IO_BACKEND``
variables choose another backend. JSON, JSONL and YAML manifests
(``load_manifest``, ``store_manifest``, the ``Json``/``Jsonl``/``Yaml``
mixins of ``Serializable``, and ``LazyMixin`` for the Set classes), the
sequential writers (``SequentialJsonlWriter`` with resume by
``ignore_ids``, ``InMemoryWriter``, ``open_writer``), and
``deserialize_item`` for the manifest types the port has (``MonoCut``,
``PaddingCut``, ``MixedCut``, ``Recording``, ``SupervisionSegment``,
``Features``, ``Array``/``TemporalArray``). YAML needs PyYAML, imported
where a YAML manifest is read or written.

Indexed reads: ``from_jsonl_lazy(shuffle=True)`` and
``load_manifest_lazy(indexed=..., index_path=...)`` open an uncompressed
JSONL through its ``.idx`` sidecar
(:class:`~lhotse_tpu_torch.lazy.LazyIndexedManifestIterator`); with
``indexed=None`` an existing sidecar is used.
Image manifests (:class:`~lhotse_tpu_torch.image.Image`) deserialize at the
top level and inside ``custom`` fields.
"""
from __future__ import annotations

import gzip
import itertools
import json
import os
import sys
import warnings
from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, Generator, Iterable, List, Optional, Type, Union

from lhotse_tpu_torch.utils import (
    Pathlike, Pipe, SmartOpen, is_module_available, is_valid_url)

# Manifest is a union of all Set types; kept as Any to avoid import cycles.
Manifest = Any

decode_json_line = json.loads


class IOBackend:
    """
    Base class for pluggable strategies of opening files/streams for reading
    and writing (reference: serialization.py:759). Subclasses register
    themselves by name; ``get_default_io_backend()`` builds a composite
    fallback chain, overridable via env var ``LHOTSE_TPU_IO_BACKEND``
    (``LHOTSE_IO_BACKEND`` is honored for compatibility).
    """

    KNOWN_BACKENDS: Dict[str, Type["IOBackend"]] = {}

    def __init_subclass__(cls, **kwargs):
        if cls.__name__ not in IOBackend.KNOWN_BACKENDS:
            IOBackend.KNOWN_BACKENDS[cls.__name__] = cls
        super().__init_subclass__(**kwargs)

    def open(self, identifier: str, mode: str):
        raise NotImplementedError()

    def is_applicable(self, identifier: str) -> bool:
        return True

    def handles_special_case(self, identifier: str) -> bool:
        """True when this backend is the designated handler for ``identifier``
        (a scheme/convention like ``-``, ``pipe:``, ``ais://``); the composite
        gives such backends priority over generic applicability
        (reference: serialization.py:787,813)."""
        return False

    @classmethod
    def is_available(cls) -> bool:
        return True

    @classmethod
    def new(cls, name: str) -> "IOBackend":
        return cls.KNOWN_BACKENDS[name]()


class RedirectIOBackend(IOBackend):
    """Maps path '-' to stdin/stdout."""

    def open(self, identifier: str, mode: str):
        if mode.startswith("r"):
            stream = sys.stdin if "b" not in mode else sys.stdin.buffer
        else:
            stream = sys.stdout if "b" not in mode else sys.stdout.buffer
        return StdStreamWrapper(stream)

    def is_applicable(self, identifier: str) -> bool:
        return str(identifier) == "-"

    def handles_special_case(self, identifier: str) -> bool:
        return str(identifier) == "-"


class PipeIOBackend(IOBackend):
    """Open 'pipe:<cmd>' identifiers as subprocess pipes."""

    def open(self, identifier: str, mode: str):
        return Pipe(str(identifier)[5:], mode=mode, shell=True)

    def is_applicable(self, identifier: str) -> bool:
        return str(identifier).startswith("pipe:")

    def handles_special_case(self, identifier: str) -> bool:
        return str(identifier).startswith("pipe:")


class GzipIOBackend(IOBackend):
    """Open .gz files with transparent (de)compression (reference: serialization.py:855)."""

    def open(self, identifier: str, mode: str):
        if "t" not in mode and "b" not in mode:
            # Default to text mode for gzip like the reference does.
            mode = mode + "t"
        # compresslevel chosen to match gzip CLI default used by the reference tools.
        if mode.startswith("w") or mode.startswith("a"):
            return gzip.open(identifier, mode, compresslevel=6, encoding=None if "b" in mode else "utf-8")
        return gzip.open(identifier, mode, encoding=None if "b" in mode else "utf-8")

    def is_applicable(self, identifier: str) -> bool:
        return str(identifier).endswith(".gz")

    def handles_special_case(self, identifier: str) -> bool:
        identifier = str(identifier)
        return identifier.endswith(".gz") and not is_valid_url(identifier)


class BuiltinIOBackend(IOBackend):
    """Plain builtin ``open``."""

    def open(self, identifier: str, mode: str):
        return open(identifier, mode)

    def is_applicable(self, identifier: str) -> bool:
        return not is_valid_url(str(identifier))


class SmartOpenIOBackend(IOBackend):
    """URLs/S3/GCS via the optional ``smart_open`` package (reference: serialization.py:887)."""

    def open(self, identifier: str, mode: str):
        return SmartOpen.open(identifier, mode)

    @classmethod
    def is_available(cls) -> bool:
        return is_module_available("smart_open")

    def is_applicable(self, identifier: str) -> bool:
        return is_valid_url(str(identifier))


AIS_ENDPOINT_ENVVAR = "AIS_ENDPOINT"


def is_aistore_available() -> bool:
    """AIS_ENDPOINT is set to a valid URL (reference: serialization.py:60)."""
    return AIS_ENDPOINT_ENVVAR in os.environ and is_valid_url(
        os.environ[AIS_ENDPOINT_ENVVAR])


@lru_cache
def get_aistore_client():
    """A cached AIStore Client for the AIS_ENDPOINT env URL."""
    if not is_module_available("aistore"):
        raise ImportError("Please run 'pip install aistore' in order to read data from AIStore.")
    if not is_aistore_available():
        raise ValueError(
            "Set a valid URL as AIS_ENDPOINT environment variable's value to "
            "read data from AIStore."
        )
    from aistore import Client

    return Client(os.environ[AIS_ENDPOINT_ENVVAR])


def get_lhotse_msc_override_protocols():
    return os.getenv("LHOTSE_MSC_OVERRIDE_PROTOCOLS", None)


def get_lhotse_msc_profile():
    return os.getenv("LHOTSE_MSC_PROFILE", None)


def get_lhotse_msc_backend_forced() -> bool:
    """True forces the MSC backend for regular URLs."""
    return os.getenv("LHOTSE_MSC_BACKEND_FORCED", "False").lower() == "true"


class AIStoreIOBackend(IOBackend):
    """AIStore client reads/writes for url identifiers (gated on the
    ``aistore`` SDK + ``AIS_ENDPOINT`` env; reference: serialization.py:894)."""

    def open(self, identifier: str, mode: str):
        client = get_aistore_client()
        obj = client.fetch_object_by_url(identifier)
        if "r" in mode:
            fileobj = obj.get_reader().as_file()
            if str(identifier).endswith(".gz"):
                from lhotse_tpu_torch.workarounds import gzip_open_robust

                fileobj = gzip_open_robust(fileobj)
            return fileobj
        if "w" in mode:
            return obj.get_writer().as_file()
        raise ValueError(f"Unsupported mode for AIStore: {mode}")

    @classmethod
    def is_available(cls) -> bool:
        return is_module_available("aistore") and is_aistore_available()

    def is_applicable(self, identifier: str) -> bool:
        return str(identifier).startswith("ais://") or is_valid_url(str(identifier))

    def handles_special_case(self, identifier: str) -> bool:
        return str(identifier).startswith("ais://")


MSC_PREFIX = "msc"


class MSCIOBackend(IOBackend):
    """NVIDIA Multi-Storage-Client for ``msc://`` URLs (gated; protocol/
    profile overrides via LHOTSE_MSC_OVERRIDE_PROTOCOLS / LHOTSE_MSC_PROFILE /
    LHOTSE_MSC_BACKEND_FORCED envs; reference: serialization.py:959-962)."""

    PREFIX = MSC_PREFIX + "://"

    def open(self, identifier: str, mode: str):
        import multistorageclient as msc

        identifier = str(identifier)
        if not identifier.startswith(self.PREFIX):
            overrides = get_lhotse_msc_override_protocols()
            if overrides:
                for proto in overrides.split(","):
                    if identifier.startswith(proto):
                        identifier = identifier.replace(proto, "msc", 1)
                        break
            profile = get_lhotse_msc_profile()
            if profile and identifier.startswith(self.PREFIX):
                rest = identifier[len(self.PREFIX) :].split("/", 1)
                tail = rest[1] if len(rest) > 1 else ""
                identifier = f"{self.PREFIX}{profile}/{tail}"
        return msc.open(identifier, mode)

    @classmethod
    def is_available(cls) -> bool:
        return is_module_available("multistorageclient")

    def is_applicable(self, identifier: str) -> bool:
        forced = get_lhotse_msc_backend_forced()
        return str(identifier).startswith(self.PREFIX) or (forced and is_valid_url(str(identifier)))

    @staticmethod
    def is_msc_url(identifier) -> bool:
        return str(identifier).startswith(MSCIOBackend.PREFIX)

    def handles_special_case(self, identifier: str) -> bool:
        return MSCIOBackend.is_msc_url(identifier)


class TarAsDirBackend(IOBackend):
    """Read files inside tar archives addressed as
    ``/path/archive.tar/member/path`` (reference: serialization.py:1187); a
    member whose name ends in ``.gz`` reads decompressed."""

    TAR_EXTS = (".tar", ".tar.gz", ".tar.bz2", ".tar.xz")

    @classmethod
    def _split(cls, identifier: str):
        for ext in cls.TAR_EXTS:
            token = ext + "/"
            if token in identifier:
                tar_path, internal = identifier.split(token, 1)
                return tar_path + ext, internal
        return None

    def open(self, identifier: str, mode: str = "r"):
        import tarfile

        split = self._split(str(identifier))
        if split is None:
            return open(identifier, mode)
        tar_path, internal = split
        if not os.path.exists(tar_path):
            raise FileNotFoundError(f"Tar file '{tar_path}' not found")
        try:
            tar = tarfile.open(tar_path, "r")
            member = tar.extractfile(internal)
            if member is None:
                raise KeyError(internal)
        except (tarfile.TarError, KeyError) as e:
            raise FileNotFoundError(f"File '{internal}' not found in '{tar_path}': {e}")
        if internal.endswith(".gz"):
            # A gzipped member reads decompressed, as a gzipped file does; the
            # JAX package hands back its compressed bytes (ROADMAP.md C2).
            return GzipIOBackend().open(member, mode)
        return member

    def is_applicable(self, identifier: str) -> bool:
        return self._split(str(identifier)) is not None

    def handles_special_case(self, identifier: str) -> bool:
        return self._split(str(identifier)) is not None


class CompositeIOBackend(IOBackend):
    """
    Composite backend trying its children in order for the first applicable one
    (reference: serialization.py:1093).
    """

    def __init__(self, backends: List[IOBackend]):
        self.backends = backends

    def open(self, identifier: str, mode: str):
        # Special-case handlers win over generic applicability regardless of
        # their position in the chain (reference: serialization.py:1062-1069).
        for b in self.backends:
            if b.handles_special_case(identifier):
                return b.open(identifier, mode)
        for b in self.backends:
            if b.is_applicable(identifier):
                return b.open(identifier, mode)
        raise RuntimeError(f"Couldn't find any applicable IOBackend for: {identifier}")

    def is_applicable(self, identifier: str) -> bool:
        return any(b.is_applicable(identifier) for b in self.backends)

    def handles_special_case(self, identifier: str) -> bool:
        return any(b.handles_special_case(identifier) for b in self.backends)


CURRENT_IO_BACKEND: Optional[IOBackend] = None


def available_io_backends() -> List[str]:
    """List the names of all available IO backends."""
    return sorted(name for name, b in IOBackend.KNOWN_BACKENDS.items() if b.is_available())


def set_current_io_backend(backend: Union[str, IOBackend]) -> None:
    global CURRENT_IO_BACKEND
    if isinstance(backend, str):
        backend = IOBackend.new(backend)
    CURRENT_IO_BACKEND = backend


def get_current_io_backend() -> IOBackend:
    if CURRENT_IO_BACKEND is not None:
        return CURRENT_IO_BACKEND
    env = os.environ.get("LHOTSE_TPU_IO_BACKEND") or os.environ.get("LHOTSE_IO_BACKEND")
    if env:
        return IOBackend.new(env)
    return get_default_io_backend()


def get_default_io_backend() -> IOBackend:
    """Composite fallback chain (reference: serialization.py:1157)."""
    backends = [RedirectIOBackend(), PipeIOBackend(), TarAsDirBackend()]
    if MSCIOBackend.is_available():
        backends.append(MSCIOBackend())
    if AIStoreIOBackend.is_available():
        backends.append(AIStoreIOBackend())
    if SmartOpenIOBackend.is_available():
        backends.append(SmartOpenIOBackend())
    backends += [GzipIOBackend(), BuiltinIOBackend()]
    return CompositeIOBackend(backends)


class io_backend:
    """Context manager temporarily overriding the current I/O backend."""

    def __init__(self, backend: Union[str, IOBackend]):
        self.backend = backend
        self.prev = None

    def __enter__(self):
        global CURRENT_IO_BACKEND
        self.prev = CURRENT_IO_BACKEND
        set_current_io_backend(self.backend)
        return self

    def __exit__(self, *exc):
        global CURRENT_IO_BACKEND
        CURRENT_IO_BACKEND = self.prev


def open_best(path: Pathlike, mode: str = "r"):
    """
    Open a path/identifier with the most appropriate strategy
    (reference: serialization.py:31): stdin/stdout redirects, subprocess
    pipes, tar members, URLs (through smart_open, AIStore or MSC where their
    packages import), gzip, and plain files.
    """
    return get_current_io_backend().open(str(path), mode)


class StdStreamWrapper:
    def __init__(self, stream):
        self.stream = stream

    def close(self):
        pass

    def __enter__(self):
        return self.stream

    def __exit__(self, exc_type, exc_val, exc_tb):
        pass

    def __getattr__(self, item: str):
        if item == "close":
            return self.close
        return getattr(self.stream, item)


def _dumps_manifest(item: Dict[str, Any]) -> str:
    """json.dumps with an actionable error for in-memory binary payloads."""
    try:
        return json.dumps(item, ensure_ascii=False)
    except TypeError as e:
        if "bytes" not in str(e):
            raise
        raise TypeError(
            f"Cannot store manifest '{item.get('id', '<no id>')}' as JSON: it "
            "contains in-memory binary data (e.g. from move_to_memory(), "
            "from_bytes(), or an attached in-memory array). JSONL manifests "
            "cannot hold raw bytes — either drop the in-memory fields, keep "
            "the data in file/archive-backed storage, or export through Shar "
            "and declare those fields in `fields=` so their payloads go into "
            "the data shards."
        ) from e


def save_to_jsonl(data: Iterable[Dict[str, Any]], path: Pathlike) -> None:
    with open_best(path, "w") as f:
        for item in data:
            print(_dumps_manifest(item), file=f)


def load_jsonl(path: Pathlike) -> Generator[Dict[str, Any], None, None]:
    with open_best(path, "r") as f:
        for line in f:
            if not line.strip():
                continue
            yield decode_json_line(line)


def save_to_json(data: Any, path: Pathlike) -> None:
    """Save data to a JSON file; gzip-compressed when path ends with ``.gz``."""
    with open_best(path, "w") as f:
        json.dump(data, f, indent=2, ensure_ascii=False)


def load_json(path: Pathlike) -> Union[dict, list]:
    with open_best(path, "r") as f:
        return json.load(f)


def save_to_yaml(data: Any, path: Pathlike) -> None:
    import yaml

    with open_best(path, "w") as f:
        try:
            yaml.safe_dump(data, stream=f, sort_keys=False)
        except TypeError:
            yaml.safe_dump(data, stream=f)


def load_yaml(path: Pathlike) -> dict:
    import yaml

    with open_best(path, "r") as f:
        return yaml.safe_load(f)


def grouper(n, iterable):
    it = iter(iterable)
    while True:
        chunk = tuple(itertools.islice(it, n))
        if not chunk:
            return
        yield chunk


def extension_contains(ext: str, path: Pathlike) -> bool:
    return any(ext == sfx for sfx in Path(path).suffixes)


#################################################
# Sequential writers
#################################################


class SequentialJsonlWriter:
    """
    Store manifests one by one without keeping the whole set in memory
    (reference: serialization.py:158). Supports resume-skip: when
    ``overwrite=False`` and the file exists, previously-written IDs are scanned
    and silently skipped on subsequent writes (queryable via ``__contains__``).
    """

    def __init__(self, path: Pathlike, overwrite: bool = True) -> None:
        self.path = path
        self.file = None
        self.mode = "w"
        self.ignore_ids = set()
        if Path(self.path).is_file() and not overwrite:
            self.mode = "a"
            with open_best(self.path, "r") as f:
                self.ignore_ids = {
                    data["id"]
                    for data in (decode_json_line(line) for line in f if line.strip())
                    if "id" in data
                }

    def __enter__(self) -> "SequentialJsonlWriter":
        self._maybe_open()
        return self

    def __exit__(self, *args, **kwargs) -> None:
        self.close()

    def __contains__(self, item: Union[str, Any]) -> bool:
        if isinstance(item, str):
            return item in self.ignore_ids
        try:
            return item.id in self.ignore_ids
        except AttributeError:
            return False

    def _maybe_open(self):
        if self.file is None:
            self.file = open_best(self.path, self.mode)

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None

    def contains(self, item: Union[str, Any]) -> bool:
        return item in self

    def write(self, manifest: Any, flush: bool = False) -> None:
        try:
            if manifest.id in self.ignore_ids:
                return
        except AttributeError:
            pass
        self._maybe_open()
        if not isinstance(manifest, dict):
            manifest = manifest.to_dict()
        print(_dumps_manifest(manifest), file=self.file)
        if flush:
            self.file.flush()

    def open_manifest(self) -> Optional[Manifest]:
        if not Path(self.path).exists():
            return None
        if self.file is not None and not self.file.closed:
            self.file.flush()
        return load_manifest_lazy(self.path)


class InvalidPathExtension(ValueError):
    pass


class InMemoryWriter:
    """
    Mimics :class:`SequentialJsonlWriter` API without performing I/O
    (reference: serialization.py:276). Used to create manifest sets in memory.
    """

    def __init__(self):
        self.items = []
        # for compatibility with SequentialJsonlWriter
        self.ignore_ids = frozenset()

    def __enter__(self):
        return self

    def __exit__(self, *args, **kwargs):
        pass

    def __contains__(self, item) -> bool:
        return False

    def contains(self, item: Union[str, Any]) -> bool:
        return item in self

    def write(self, manifest, flush: bool = False) -> None:
        self.items.append(manifest)

    def open_manifest(self) -> Optional[Manifest]:
        if not self.items:
            return None
        cls = resolve_manifest_set_class(self.items[0])
        return cls.from_items(self.items)


class JsonMixin:
    def to_json(self, path: Pathlike) -> None:
        save_to_json([item.to_dict() for item in self], path)

    @classmethod
    def from_json(cls, path: Pathlike) -> Manifest:
        data = load_json(path)
        return cls.from_dicts(data)


class YamlMixin:
    def to_yaml(self, path: Pathlike) -> None:
        save_to_yaml([item.to_dict() for item in self], path)

    @classmethod
    def from_yaml(cls, path: Pathlike) -> Manifest:
        data = load_yaml(path)
        return cls.from_dicts(data)


class JsonlMixin:
    def to_jsonl(self, path: Pathlike) -> None:
        save_to_jsonl((item.to_dict() for item in self), path)

    @classmethod
    def from_jsonl(cls, path: Pathlike) -> Manifest:
        data = load_jsonl(path)
        return cls.from_dicts(data)

    @classmethod
    def open_writer(
        cls, path: Union[Pathlike, None], overwrite: bool = True,
    ) -> Union[SequentialJsonlWriter, InMemoryWriter]:
        """
        Open a sequential writer that allows to store the manifests one by one,
        without the necessity of storing the whole manifest set in-memory.
        When ``path`` is None, an in-memory writer is returned instead.
        """
        if path is None:
            return InMemoryWriter()
        return SequentialJsonlWriter(path, overwrite=overwrite)


class LazyMixin:
    def from_items(self, data: Iterable):
        """Create a manifest set from items (alias for constructor)."""
        return type(self)(data)

    @property
    def data(self) -> Union[Dict[str, Any], Iterable[Any]]:
        """Alias property for ``self.items``."""
        return self.items

    @property
    def is_lazy(self) -> bool:
        """Indicates whether this manifest was opened in lazy (read-on-the-fly) mode or not."""
        return not isinstance(self.data, (dict, list, tuple))

    def to_eager(self):
        """
        Evaluates all lazy operations on this manifest and returns an eager
        variant holding all items in memory.
        """
        cls = type(self)
        if not self.is_lazy and isinstance(self.data, (dict, list)):
            return self
        return cls.from_items(list(self))

    @classmethod
    def from_jsonl_lazy(cls, path: Pathlike, shuffle: bool = False, seed: int = 0) -> Manifest:
        """
        Read a JSONL manifest in a lazy manner: the underlying file is opened
        per iteration and items are deserialized on the fly.

        With ``shuffle=True``, an ``.idx``-backed
        :class:`~lhotse_tpu_torch.lazy.LazyIndexedManifestIterator` provides O(1)
        random-access shuffled iteration (reference: serialization.py:405 —
        requires an uncompressed ``.jsonl``).
        """
        if shuffle:
            from lhotse_tpu_torch.lazy import LazyIndexedManifestIterator

            return cls(LazyIndexedManifestIterator(path, shuffle=True, seed=seed))
        from lhotse_tpu_torch.lazy import LazyManifestIterator

        return cls(LazyManifestIterator(path))


def load_manifest(path: Pathlike, manifest_cls: Optional[Type] = None) -> Manifest:
    """Generic utility for reading an arbitrary manifest (reference: serialization.py:450)."""
    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.features import FeatureSet
    from lhotse_tpu_torch.supervision import SupervisionSet

    if extension_contains(".jsonl", path):
        raw_data = load_jsonl(path)
        if manifest_cls is None:
            raw_data = list(raw_data)
    elif extension_contains(".json", path):
        raw_data = load_json(path)
    elif extension_contains(".yaml", path):
        raw_data = load_yaml(path)
    else:
        raise ValueError(f"Not a valid manifest (does the path exist?): {path}")
    data_set = None
    if manifest_cls is not None:
        candidates = [manifest_cls]
    else:
        candidates = [RecordingSet, SupervisionSet, FeatureSet, CutSet]
    for manifest_type in candidates:
        try:
            data_set = manifest_type.from_dicts(raw_data)
            # Empty data cannot disambiguate the type — but with an explicit
            # manifest_cls there is no ambiguity, so a legitimately empty
            # manifest (e.g. an absent corpus split) loads fine.  The
            # reference (serialization.py:478-484) rejects empty manifests
            # unconditionally.
            if len(data_set) == 0 and manifest_cls is None:
                raise RuntimeError()
            break
        except Exception:
            data_set = None
    if data_set is None:
        raise ValueError(f"Unknown type of manifest: {path}")
    return data_set


def load_manifest_lazy(
    path: Pathlike, indexed: Optional[bool] = None, shuffle: bool = False, seed: int = 0,
    index_path: Optional[Pathlike] = None) -> Optional[Manifest]:
    """
    Generic utility for reading an arbitrary manifest from a JSONL file lazily
    (reference: serialization.py:490). Returns None when the manifest is empty.
    """
    assert extension_contains(".jsonl", path) or str(path) == "-"
    raw_data = iter(load_jsonl(path))
    try:
        first = next(raw_data)
    except StopIteration:
        return None
    item = deserialize_item(first)
    cls = resolve_manifest_set_class(item)

    if shuffle or indexed:
        from lhotse_tpu_torch.lazy import LazyIndexedManifestIterator

        return cls(
            LazyIndexedManifestIterator(
                path, shuffle=shuffle, seed=seed, index_path=index_path
            )
        )
    if indexed is None:
        from lhotse_tpu_torch.indexing import default_index_path

        idx = Path(index_path) if index_path is not None else default_index_path(path)
        if idx.is_file():
            from lhotse_tpu_torch.lazy import LazyIndexedManifestIterator

            return cls(LazyIndexedManifestIterator(path, index_path=index_path))
    from lhotse_tpu_torch.lazy import LazyManifestIterator

    return cls(LazyManifestIterator(path))


def load_manifest_lazy_or_eager(
    path: Pathlike, manifest_cls=None, indexed: Optional[bool] = None, shuffle: bool = False,
    seed: int = 0, index_path: Optional[Pathlike] = None) -> Optional[Manifest]:
    """
    Generic utility for reading an arbitrary manifest: JSONL opens lazily,
    other formats open eagerly.
    """
    if extension_contains(".jsonl", path) or str(path) == "-":
        out = load_manifest_lazy(
            path, indexed=indexed, shuffle=shuffle, seed=seed, index_path=index_path)
        if manifest_cls is not None and out is not None:
            assert isinstance(
                out, manifest_cls), f"Expected {manifest_cls} but got {type(out)} from {path}"
        return out
    return load_manifest(path, manifest_cls=manifest_cls)


def resolve_manifest_set_class(item):
    """Returns the Set class corresponding to the provided manifest item type
    (reference: serialization.py:570)."""
    from lhotse_tpu_torch.audio import Recording, RecordingSet
    from lhotse_tpu_torch.cut import Cut, CutSet
    from lhotse_tpu_torch.features import Features, FeatureSet
    from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet

    if isinstance(item, Recording):
        return RecordingSet
    if isinstance(item, SupervisionSegment):
        return SupervisionSet
    if isinstance(item, Cut):
        return CutSet
    if isinstance(item, Features):
        return FeatureSet
    raise NotALhotseManifest(
        f"No corresponding 'Set' class is known for item of type: {type(item)}"
    )


class NotALhotseManifest(Exception):
    pass


def store_manifest(manifest: Manifest, path: Pathlike) -> None:
    if extension_contains(".jsonl", path) or str(path) == "-":
        manifest.to_jsonl(path)
    elif extension_contains(".json", path):
        manifest.to_json(path)
    elif extension_contains(".yaml", path):
        manifest.to_yaml(path)
    else:
        raise ValueError(f"Unknown serialization format for: {path}")


class Serializable(JsonMixin, JsonlMixin, LazyMixin, YamlMixin):
    @classmethod
    def from_file(
        cls, path: Pathlike, indexed: Optional[bool] = None, shuffle: bool = False, seed: int = 0,
        index_path: Optional[Pathlike] = None) -> Manifest:
        """Read a manifest from a file (JSONL lazy; JSON/YAML eager)."""
        return load_manifest_lazy_or_eager(
            path, manifest_cls=cls, indexed=indexed, shuffle=shuffle, seed=seed,
            index_path=index_path)

    def to_file(self, path: Pathlike) -> None:
        store_manifest(self, path)


def deserialize_item(data: dict) -> Any:
    """
    Figure out what type of manifest is being decoded with heuristics on the
    present keys, and return a typed manifest object (reference:
    serialization.py:656).
    """
    from lhotse_tpu_torch.array import deserialize_array
    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.cut import MixedCut, MonoCut, MultiCut, PaddingCut
    from lhotse_tpu_torch.features import Features
    from lhotse_tpu_torch.image import Image
    from lhotse_tpu_torch.supervision import SupervisionSegment

    if "width" in data:
        return Image.from_dict(data)
    if "shape" in data or "array" in data:
        return deserialize_array(data)
    if "sources" in data:
        return Recording.from_dict(data)
    if "num_features" in data:
        return Features.from_dict(data)
    if "type" not in data:
        return SupervisionSegment.from_dict(data)
    cut_type = data.pop("type")
    if cut_type == "MonoCut":
        return MonoCut.from_dict(data)
    if cut_type == "MultiCut":
        return MultiCut.from_dict(data)
    if cut_type == "PaddingCut":
        return PaddingCut.from_dict(data)
    if cut_type == "Cut":
        warnings.warn("Manifest uses legacy cut type name 'Cut'; interpreting as MonoCut.")
        return MonoCut.from_dict(data)
    if cut_type == "MixedCut":
        return MixedCut.from_dict(data)
    raise ValueError(f"Unexpected cut type during deserialization: '{cut_type}'")


def deserialize_custom_field(data: Optional[dict]) -> Optional[dict]:
    """
    Deserialize manifests inside a ``custom`` field dict in-place
    (reference: serialization.py:703). Dict values that look like Recording
    Image / Array manifests are converted; everything else is left as-is.
    """
    if data is None:
        return None
    from lhotse_tpu_torch.array import deserialize_array
    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.image import Image

    for key, value in data.items():
        if isinstance(value, dict):
            if all(k in value for k in ("id", "sources", "sampling_rate")):
                data[key] = Recording.from_dict(value)
                continue
            if "width" in value:
                data[key] = Image.from_dict(value)
                continue
            try:
                data[key] = deserialize_array(value)
            except Exception:
                pass
    return data
