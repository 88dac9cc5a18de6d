"""
Manifest (de)serialization for local JSONL files (copied from
``lhotse_tpu/serialization.py``): ``open_best`` over plain and gzipped
files, ``Serializable`` and ``LazyMixin`` for the Set classes, the
sequential writers (``SequentialJsonlWriter`` with resume by ``ignore_ids``,
``InMemoryWriter``, ``open_writer``), and ``deserialize_item`` for the
manifest types the port has (``MonoCut``, ``Recording``,
``SupervisionSegment``, ``Features``, ``Array``/``TemporalArray``).

Indexed reads: ``from_jsonl_lazy(shuffle=True)`` and
``load_manifest_lazy(indexed=..., index_path=...)`` open an uncompressed
JSONL through its ``.idx`` sidecar
(:class:`~lhotse_tpu_torch.lazy.LazyIndexedManifestIterator`); with
``indexed=None`` an existing sidecar is used.

Left out, and raising ``NotImplementedError`` where a manifest asks for
them: pipes, URLs and the other remote I/O backends, JSON/YAML manifests,
and the manifest types the port does not have yet (images, ``MultiCut``).
"""
from __future__ import annotations

import gzip
import json
import warnings
from pathlib import Path
from typing import Any, Dict, Generator, Iterable, List, Optional, Type, Union

from lhotse_tpu_torch.utils import Pathlike, is_valid_url, not_ported

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


def get_current_io_backend() -> IOBackend:
    if CURRENT_IO_BACKEND is not None:
        return CURRENT_IO_BACKEND
    return get_default_io_backend()


def get_default_io_backend() -> IOBackend:
    """Composite fallback chain (reference: serialization.py:1157), of the
    two local-file backends the port has."""
    backends = [GzipIOBackend(), BuiltinIOBackend()]
    return CompositeIOBackend(backends)


def open_best(path: Pathlike, mode: str = "r"):
    """
    Open a path/identifier with the most appropriate strategy
    (reference: serialization.py:31): gzip and plain files.
    """
    return get_current_io_backend().open(str(path), mode)


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
    raise not_ported(f"load_manifest (JSON/YAML manifests such as {path})")


def resolve_manifest_set_class(item):
    """Returns the Set class corresponding to the provided manifest item type
    (reference: serialization.py:570)."""
    from lhotse_tpu_torch.cut import Cut, CutSet
    from lhotse_tpu_torch.features import Features, FeatureSet

    if isinstance(item, Cut):
        return CutSet
    if isinstance(item, Features):
        return FeatureSet
    set_names = {"Recording": "RecordingSet", "SupervisionSegment": "SupervisionSet"}
    if type(item).__name__ in set_names:
        raise not_ported(set_names[type(item).__name__])
    raise NotALhotseManifest(
        f"No corresponding 'Set' class is known for item of type: {type(item)}"
    )


class NotALhotseManifest(Exception):
    pass


def store_manifest(manifest: Manifest, path: Pathlike) -> None:
    if extension_contains(".jsonl", path) or str(path) == "-":
        manifest.to_jsonl(path)
    elif extension_contains(".json", path) or extension_contains(".yaml", path):
        raise not_ported(f"JSON/YAML manifests ({path})")
    else:
        raise ValueError(f"Unknown serialization format for: {path}")


class Serializable(JsonlMixin, LazyMixin):
    @classmethod
    def from_file(
        cls, path: Pathlike, indexed: Optional[bool] = None, shuffle: bool = False, seed: int = 0,
        index_path: Optional[Pathlike] = None) -> Manifest:
        """Read a manifest from a JSONL file, lazily."""
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
    from lhotse_tpu_torch.cut import MixedCut, MonoCut, PaddingCut
    from lhotse_tpu_torch.features import Features
    from lhotse_tpu_torch.supervision import SupervisionSegment

    if "width" in data:
        raise not_ported("Image manifests")
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
        raise not_ported("MultiCut")
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
    or Array manifests are converted; Image manifests raise; everything else
    is left as-is.
    """
    if data is None:
        return None
    from lhotse_tpu_torch.array import deserialize_array
    from lhotse_tpu_torch.audio import Recording

    for key, value in data.items():
        if isinstance(value, dict):
            if all(k in value for k in ("id", "sources", "sampling_rate")):
                data[key] = Recording.from_dict(value)
                continue
            if "width" in value:
                raise not_ported(f"Image manifests (custom field {key!r})")
            try:
                data[key] = deserialize_array(value)
            except Exception:
                pass
    return data
