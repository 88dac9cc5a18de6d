"""
Random-access Shar reading.

Where the streaming reader (:class:`~lhotse_tpu_torch.shar.readers.lazy.LazySharIterator`)
walks tars front to back, this module treats a whole Shar dump as one indexed
sequence: binary ``.idx`` sidecars give byte offsets for every jsonl record
and tar member, so any cut — in any shard — is a couple of ``pread`` calls
away.  That unlocks true global shuffling (seekable Feistel permutation),
topology-aware worker partitioning, and O(1) checkpoint restore.

Layout of this module:

* :class:`ShardCatalog` — discovers/validates the per-field shard files and
  their indexes, owns the flat-index arithmetic and the per-shard readers.
* :class:`LazyIndexedSharIterator` — the IteratorNode that composes a catalog
  with a :class:`~lhotse_tpu_torch.dataset.dataloading.PartitionedIndexedIterator`.

Copied from ``lhotse_tpu/shar/readers/indexed.py``.
"""
import bisect
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from lhotse_tpu_torch.cut import Cut
from lhotse_tpu_torch.dataset.dataloading import PartitionedIndexedIterator, resolve_seed
from lhotse_tpu_torch.indexing import (
    create_jsonl_index, create_tar_index, index_exists, indexed_path_kind,
    validate_indexed_access)
from lhotse_tpu_torch.lazy import IteratorNode, attach_graph_origin, normalize_graph_token
from lhotse_tpu_torch.serialization import deserialize_item, extension_contains
from lhotse_tpu_torch.shar.readers.lazy import _discover_fields
from lhotse_tpu_torch.utils import Pathlike, exactly_one_not_null, is_valid_url


def _suffixed_index_path(index_dir: Pathlike, data_path: Pathlike) -> Pathlike:
    """``<index_dir>/<basename of data_path>.idx`` (URL-aware join)."""
    name = Path(str(data_path)).name + ".idx"
    if isinstance(index_dir, Path):
        return index_dir / name
    index_dir = str(index_dir)
    if is_valid_url(index_dir):
        return f"{index_dir.rstrip('/')}/{name}"
    return Path(index_dir) / name


def _mirror_under_root(
    streams: Dict[str, Sequence[Pathlike]], indexes_root: Pathlike) -> Dict[str, List[Pathlike]]:
    """Map every shard data path to ``<root>/<path-without-scheme>.idx``."""
    root = Path(indexes_root)
    mirrored: Dict[str, List[Pathlike]] = {}
    for field, shard_paths in streams.items():
        entries = []
        for p in shard_paths:
            text = str(p)
            if "://" in text:
                text = text.split("://", 1)[1]
            entries.append(root / (text.lstrip("/") + ".idx"))
        mirrored[field] = entries
    return mirrored



class ShardCatalog:
    """
    The static description of an indexed Shar dump: which files hold which
    field of which shard, where their ``.idx`` files live, how long each
    shard is — plus lazily-constructed per-shard readers.
    """

    def __init__(
        self, *, fields: Optional[Dict[str, Sequence[Pathlike]]] = None,
        in_dir: Optional[Pathlike] = None,
        index_path: Optional[Union[Pathlike, Dict[str, Sequence[Pathlike]]]] = None,
        indexes_root: Optional[Pathlike] = None, create_missing_indexes: bool = True) -> None:
        if index_path is not None and indexes_root is not None:
            raise ValueError(
                "ShardCatalog accepts 'index_path' (explicit locations) or "
                "'indexes_root' (a mirroring root), but not both at once."
            )
        if not exactly_one_not_null(fields, in_dir):
            raise AssertionError(
                "To read the Shar format, provide either 'in_dir' or 'fields' argument."
            )

        if in_dir is not None:
            _, self.streams = _discover_fields(Path(in_dir))
        else:
            if "cuts" not in fields:
                raise AssertionError(
                    "To initialize the Shar reader, please provide the value "
                    "for key 'cuts' in 'fields'."
                )
            self.streams = fields
        self.data_fields = set(self.streams) - {"cuts"}

        self.num_shards = len(self.streams["cuts"])
        for f in self.data_fields:
            if len(self.streams[f]) != self.num_shards:
                raise AssertionError(
                    f"Field '{f}' has {len(self.streams[f])} shard files but the "
                    f"cuts manifest has {self.num_shards}: {self.streams[f]}"
                )

        if indexes_root is not None:
            index_path = _mirror_under_root(self.streams, indexes_root)
        self.index_streams = self._locate_indexes(index_path, from_dir=in_dir is not None)
        self._check_and_index(create_missing_indexes)

        from lhotse_tpu_torch.indexing import IndexedJsonlReader

        self._cut_readers = [
            IndexedJsonlReader(p, index_path=self.index_for("cuts", i)) for i,
            p in enumerate(self.streams["cuts"])]
        lengths = [len(r) for r in self._cut_readers]
        self._first_flat: List[int] = []
        acc = 0
        for n in lengths:
            self._first_flat.append(acc)
            acc += n
        self.total = acc
        self._field_readers: Dict[int, dict] = {}

    # -- index bookkeeping -----------------------------------------------------

    def _locate_indexes(self, index_path, *, from_dir: bool):
        if index_path is None:
            return None
        if not isinstance(index_path, dict):
            if from_dir:
                # A single directory: every shard's index is <dir>/<file>.idx.
                return {
                    f: [_suffixed_index_path(index_path, p) for p in paths] for f,
                    paths in self.streams.items()}
            raise TypeError(
                "With 'fields', 'index_path' must map field names to lists of "
                f".idx paths; got {type(index_path)}."
            )
        # Dict form (explicit per-field lists, incl. the indexes_root mirror)
        # is validated the same way regardless of in_dir/fields construction.
        for f, idx_paths in index_path.items():
            if f not in self.streams:
                raise ValueError(
                    f"index_path names unknown field '{f}'; known fields: "
                    f"{set(self.streams)}"
                )
            if len(idx_paths) != len(self.streams[f]):
                raise ValueError(
                    f"index_path['{f}'] lists {len(idx_paths)} indexes for "
                    f"{len(self.streams[f])} data shards."
                )
        return {f: list(v) for f, v in index_path.items()}

    def index_for(self, field: str, shard: int) -> Optional[Pathlike]:
        if self.index_streams is None or field not in self.index_streams:
            return None
        return self.index_streams[field][shard]

    def _check_and_index(self, create_missing: bool) -> None:
        for field, shard_paths in self.streams.items():
            want_kind = "jsonl" if field == "cuts" else None
            for shard, path in enumerate(shard_paths):
                where = f"Shar field '{field}' shard {shard}"
                validate_indexed_access(path, kind=want_kind, context=where)
                kind = indexed_path_kind(path)
                idx = self.index_for(field, shard)
                if index_exists(path, index_path=idx):
                    continue
                if not create_missing:
                    raise FileNotFoundError(
                        f"{where} has no index file "
                        f"(looked at {idx if idx is not None else str(path) + '.idx'})."
                    )
                (create_jsonl_index if kind == "jsonl" else create_tar_index)(path, output_path=idx)

    # -- addressing -------------------------------------------------------------

    def split_flat(self, flat: int) -> Tuple[int, int]:
        """Flat cut index -> (shard, position inside shard)."""
        if flat < 0:
            flat += self.total
        if not 0 <= flat < self.total:
            raise IndexError(f"Cut index {flat} outside the catalog's {self.total} cuts.")
        shard = bisect.bisect_right(self._first_flat, flat) - 1
        return shard, flat - self._first_flat[shard]

    def cuts_path(self, shard: int) -> Pathlike:
        return self.streams["cuts"][shard]

    def read_cut_record(self, shard: int, pos: int) -> dict:
        return self._cut_readers[shard][pos]

    def field_readers(self, shard: int) -> dict:
        """Per-field indexed readers for one shard, built on first use."""
        got = self._field_readers.get(shard)
        if got is not None:
            return got
        from lhotse_tpu_torch.indexing import IndexedJsonlReader, IndexedTarReader

        made = {}
        for f in self.data_fields:
            path = self.streams[f][shard]
            cls = IndexedTarReader if extension_contains(".tar", path) else IndexedJsonlReader
            made[f] = cls(path, index_path=self.index_for(f, shard))
        self._field_readers[shard] = made
        return made

    # -- pickling: readers hold open files; rebuild them on the other side -------

    def __getstate__(self):
        d = self.__dict__.copy()
        d["_cut_readers"] = None
        d["_field_readers"] = {}
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        from lhotse_tpu_torch.indexing import IndexedJsonlReader

        self._cut_readers = [
            IndexedJsonlReader(p, index_path=self.index_for("cuts", i)) for i,
            p in enumerate(self.streams["cuts"])]


class LazyIndexedSharIterator(IteratorNode):
    """
    O(1)-addressable Shar reader.

    Compared to the streaming reader it requires uncompressed, seekable
    jsonl/tar shards (auto-creating any missing ``.idx``), and in exchange
    offers ``reader[i]`` across shard boundaries, a seeded global Feistel
    shuffle, per-(rank, worker) partitioned iteration, and exact O(1) resume.

    :param fields / in_dir: the Shar dump, exactly as for LazySharIterator.
    :param shuffle: iterate a seeded permutation instead of storage order.
    :param seed: permutation seed (int, or "randomized"/"trng" specs).
    :param split_for_dataloading: give each (node, worker) a disjoint slice;
        topology is recorded in checkpoints and validated on resume.
    :param index_path: where the ``.idx`` files live — a directory (with
        ``in_dir``) or a per-field dict of path lists (with ``fields``).
    :param indexes_root: alternative to ``index_path``: a root mirroring the
        data paths.
    :param lazy: attach ``shar_ptr`` byte-range pointers instead of reading
        tar payloads during iteration (payloads load on first use).
    """

    is_checkpointable = True

    def __init__(
        self, fields: Optional[Dict[str, Sequence[Pathlike]]] = None,
        in_dir: Optional[Pathlike] = None, *, shuffle: bool = False, seed: Union[int, str] = 42,
        split_for_dataloading: bool = False,
        index_path: Optional[Union[Pathlike, Dict[str, Sequence[Pathlike]]]] = None,
        indexes_root: Optional[Pathlike] = None, lazy: bool = False) -> None:
        self.in_dir = Path(in_dir) if in_dir is not None else None
        self.catalog = ShardCatalog(
            fields=fields, in_dir=in_dir, index_path=index_path, indexes_root=indexes_root)
        self.shuffle = shuffle
        self.seed = seed
        self.split_for_dataloading = split_for_dataloading
        self._lazy = lazy
        self.epoch = 0
        # Partition/permutation order and its checkpoint state live in the
        # PartitionedIndexedIterator (it refuses resume under a different
        # world_size/num_workers, where stride-split would silently diverge).
        self._iter_state = PartitionedIndexedIterator(
            shuffle=shuffle, seed=resolve_seed(seed) if isinstance(seed, int) else 0)

    # -- compat accessors used elsewhere in the package -------------------------

    @property
    def fields(self) -> set:
        return self.catalog.data_fields

    @property
    def streams(self) -> Dict[str, Sequence[Pathlike]]:
        return self.catalog.streams

    @property
    def num_shards(self) -> int:
        return self.catalog.num_shards

    @classmethod
    def supports_configuration(
        cls, *, fields: Optional[Dict[str, Sequence[Pathlike]]] = None,
        in_dir: Optional[Pathlike] = None,
        index_path: Optional[Union[Pathlike, Dict[str, Sequence[Pathlike]]]] = None,
        indexes_root: Optional[Pathlike] = None) -> bool:
        """True when every shard is seekable and already has its index."""
        try:
            ShardCatalog(
                fields=fields, in_dir=in_dir, index_path=index_path, indexes_root=indexes_root,
                create_missing_indexes=False)
            return True
        except (AssertionError, TypeError, ValueError, FileNotFoundError, RuntimeError):
            return False

    @property
    def is_indexed(self) -> bool:
        return True

    @property
    def has_constant_time_access(self) -> bool:
        return True

    def __len__(self) -> int:
        return self.catalog.total

    # -- record assembly ----------------------------------------------------------

    def __getitem__(self, token: Any) -> Cut:
        """Fetch one fully-assembled cut by flat index or (index, epoch) token."""
        token = normalize_graph_token(token)
        epoch_tag = self.epoch
        if isinstance(token, tuple):
            if len(token) != 2:
                raise TypeError(f"Expected an int or (flat_index, shar_epoch) token, got {token!r}")
            token, epoch_tag = token
        shard, pos = self.catalog.split_flat(token)
        cut = deserialize_item(self.catalog.read_cut_record(shard, pos))
        for field, reader in self.catalog.field_readers(shard).items():
            self._attach_field(cut, field, reader, pos)
        cut.shard_origin = self.catalog.cuts_path(shard)
        cut.shar_epoch = epoch_tag
        flat = token if token >= 0 else token + self.catalog.total
        attach_graph_origin(cut, (flat, epoch_tag))
        return cut

    def _attach_field(self, cut: Cut, field: str, reader, pos: int) -> None:
        from lhotse_tpu_torch.indexing import IndexedTarReader

        if not isinstance(reader, IndexedTarReader):
            record = reader[pos]
            if field in record:
                setattr(cut, field, record[field])
            return
        if self._lazy:
            # Don't touch tar payload bytes now; leave a shar_ptr that
            # resolves via pread on first load_audio()/load_features().
            lo, hi = reader.member_byte_range(pos)
            if hi <= lo:
                return  # zero-length placeholder member
            from lhotse_tpu_torch.shar.utils import fill_shar_placeholder_lazy

            fill_shar_placeholder_lazy(
                cut, field=field, tar_path=str(reader.path), offset=lo, end_offset=hi)
            return
        manifest, member_path = reader[pos]
        if manifest is None:
            return
        member_id = str(member_path.parent / member_path.stem)
        if member_id != cut.id:
            raise AssertionError(
                f"Shar shard misalignment: cut '{cut.id}' was paired with tar "
                f"member '{member_path}' of field '{field}'."
            )
        setattr(cut, field, manifest)

    # -- iteration / state ----------------------------------------------------------

    def __iter__(self):
        partition = None
        if self.split_for_dataloading:
            # Honor the explicit API request even without the env-gated
            # worker_init_fn activation (the streaming reader splits at the
            # shard level; here we split the flat item range the same way).
            from lhotse_tpu_torch.shar.readers.utils import worker_info

            rank, world, worker, num_workers = worker_info()
            partition = (rank * num_workers + worker, world * num_workers)
        # Eager: iterate() resets/resumes partition state at this call.
        positions = self._iter_state.iterate(self.catalog.total, partition=partition)

        def gen():
            for flat in positions:
                yield self[flat]
            self.epoch += 1

        return gen()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def state_dict(self) -> dict:
        sd = dict(self._iter_state.state_dict())
        sd.update(epoch=self.epoch, shuffle=self.shuffle, seed=self.seed, lazy=self._lazy)
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self._iter_state.load_state_dict(sd)
        self.epoch = sd.get("epoch", 0)
        if "lazy" in sd:
            self._lazy = bool(sd["lazy"])
