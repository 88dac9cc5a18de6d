"""
Streaming Shar reader (copied from ``lhotse_tpu/shar/readers/lazy.py``):
:class:`LazySharIterator` discovers the fields of a Shar directory, splits
the shards across (node, worker) pairs, shuffles them per epoch and zips
each shard's cut manifest with its field tars; it checkpoints the shard
order and the position in the current shard.
"""
import random
from pathlib import Path
from typing import (Callable, Dict, Generator, List, Optional, Sequence, Tuple, Union)

from lhotse_tpu_torch.cut import Cut
from lhotse_tpu_torch.dataset.dataloading import resolve_seed
from lhotse_tpu_torch.lazy import (
    IteratorNode, LazyJsonlIterator, LazyManifestIterator, count_newlines_fast)
from lhotse_tpu_torch.serialization import extension_contains
from lhotse_tpu_torch.shar.readers.tar import TarIterator
from lhotse_tpu_torch.utils import Pathlike, exactly_one_not_null, ifnone


def _is_local_uncompressed(path) -> bool:
    """True if *path* is a local, uncompressed file (not pipe/URL/gz)."""
    p = str(path)
    if p.startswith("pipe:") or "://" in p:
        return False
    return not extension_contains(".gz", p)


def _discover_fields(in_dir: Path) -> Tuple[set, dict]:
    """
    Discover shard fields in a directory: returns ``(fields, streams)`` where
    *streams* maps each field (plus "cuts") to a sorted shard-path list.
    ``.idx`` sidecars are excluded.
    """
    streams: Dict[str, list] = {}
    for p in in_dir.glob("*"):
        if p.suffix == ".idx":
            continue
        field = p.name.split(".")[0]
        if field == "cuts" and not extension_contains(".jsonl", p):
            continue
        streams.setdefault(field, []).append(p)
    assert "cuts" in streams, f"No cuts JSONL shards found in {in_dir}"
    for shard_list in streams.values():
        shard_list.sort()
    fields = set(streams) - {"cuts"}
    return fields, streams


class LazySharIterator(IteratorNode):
    """
    Streams cuts + data from Shar shards: for the current shard it keeps the
    jsonl manifest and all field tarfiles open, zipping them item-by-item and
    attaching binary data to the cuts (accessible via ``cut.load_audio()``
    etc.).

    Load a SharWriter directory::

        >>> cuts = LazySharIterator(in_dir="some_dir")

    or explicit per-field shard lists (paths, "pipe:" commands, or URLs)::

        >>> cuts = LazySharIterator({
        ...     "cuts": ["some_dir/cuts.000000.jsonl.gz"],
        ...     "recording": ["another_dir/recording.000000.tar"],
        ... })

    :param fields: dict of field → shard list; must include "cuts".
    :param in_dir: SharWriter output directory (alternative to fields).
    :param split_for_dataloading: give each node+worker a unique shard
        subset (mutually exclusive with seed='randomized').
    :param shuffle_shards: shuffle shard order (same on each node per seed).
    :param seed: int / 'randomized' (per node+worker via worker_init_fn) /
        'trng' (non-reproducible).
    :param stateful_shuffle: reshuffle with seed+epoch on each full pass.
    :param cut_map_fns: per-shard cut transform callables.
    :param slice_length: read only a random slice of this many examples from
        each shard (randomness/efficiency tradeoff for large-shard setups).
    """

    is_checkpointable = True

    def __init__(
        self, fields: Optional[Dict[str, Sequence[Pathlike]]] = None,
        in_dir: Optional[Pathlike] = None, split_for_dataloading: bool = False,
        shuffle_shards: bool = False, stateful_shuffle: bool = True, seed: Union[int, str] = 42,
        cut_map_fns: Optional[Sequence[Callable[[Cut], Cut]]] = None,
        slice_length: Optional[int] = None) -> None:
        assert exactly_one_not_null(fields, in_dir), (
            "To read the Shar format, provide either 'in_dir' or 'fields' argument."
        )
        if split_for_dataloading:
            assert seed not in ("randomized", "trng"), (
                "Error: setting seed to 'randomized' or 'trng' and using "
                "split_for_dataloading=True are mutually exclusive options as "
                "they would result in data loss."
            )

        self.split_for_dataloading = split_for_dataloading
        self.shuffle_shards, self.stateful_shuffle = shuffle_shards, stateful_shuffle
        self.seed, self.slice_length = seed, slice_length
        self.epoch, self._len = 0, None

        if in_dir is not None:
            self.in_dir = Path(in_dir)
            self.fields, self.streams = _discover_fields(self.in_dir)
        else:
            self._init_from_inputs(fields)

        self.num_shards = len(self.streams["cuts"])
        for field in self.fields:
            found = len(self.streams[field])
            assert found == self.num_shards, (
                f"Expected {self.num_shards} shards available for field "
                f"'{field}' but found {found}: {self.streams[field]}"
            )

        self.shards = [
            {field: self.streams[field][shard_idx] for field in self.streams}
            for shard_idx in range(self.num_shards)
        ]

        self.cut_map_fns = ifnone(cut_map_fns, [None] * self.num_shards)
        self._restored = False

    def _init_from_inputs(self, fields: Optional[Dict[str, Sequence[str]]] = None):
        assert "cuts" in fields, (
            "To initialize the Shar reader, please provide the value for key "
            "'cuts' in 'fields'."
        )
        self.fields = set(fields.keys())
        self.fields.remove("cuts")
        self.streams = fields

    @property
    def is_indexed(self) -> bool:
        """Always False — this is the streaming reader."""
        return False

    def _maybe_split_for_dataloading(self, shards: List) -> List:
        from lhotse_tpu_torch.shar.readers.utils import split_by_node, split_by_worker

        if self.split_for_dataloading:
            return split_by_worker(split_by_node(shards))
        else:
            return shards

    def _get_rng(self) -> random.Random:
        seed = resolve_seed(self.seed)
        if self.stateful_shuffle:
            seed += self.epoch
        return random.Random(seed)

    def _maybe_shuffle_shards(self, shards: List) -> List:
        if self.shuffle_shards:
            shards = shards.copy()
            self._get_rng().shuffle(shards)
        return shards

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = self._get_rng()
        if self._restored:
            # Resume: saved shard order and positions.
            self._restored = False
            start_shard, skip_in_shard = self._current_shard_idx, self._position_in_shard
        else:
            fresh = self._maybe_split_for_dataloading(
                self._maybe_shuffle_shards(list(range(len(self.shards))))
            )
            self._shard_order, start_shard, skip_in_shard = fresh, 0, 0

        map_fns = self.cut_map_fns
        for i in range(start_shard, len(self._shard_order)):
            orig_idx = self._shard_order[i]
            self._current_shard_idx, self._position_in_shard = i, 0
            yield from self._iter_shard(
                self.shards[orig_idx],
                cut_map_fn=map_fns[orig_idx] if map_fns is not None else None, rng=rng,
                skip=skip_in_shard if i == start_shard else 0)

        self.epoch += 1

    def _open_field_streams(self, shard: dict) -> dict:
        """field -> iterator of (manifest-or-None, member path) pairs."""
        return {
            field: ( TarIterator(path) if extension_contains(".tar", path) else _jsonl_tar_adaptor(LazyJsonlIterator(path), field=field) ) for field,
            path in shard.items() if field != "cuts"}

    def _attach(self, cut, field_streams, field_data) -> None:
        for field, (manifest, member_path) in zip(field_streams, field_data):
            if manifest is None:
                continue  # field absent for this cut
            member_id = str(member_path.parent / member_path.stem)
            assert member_id == cut.id, (
                f"Mismatched IDs: cut ID is '{cut.id}' but found data "
                f"with name '{member_path}' for field {field}"
            )
            setattr(cut, field, manifest)

    def _iter_shard(self, shard: dict, *, cut_map_fn, rng, skip: int):
        cuts = LazyManifestIterator(shard["cuts"])
        take = self.slice_length
        first = -1
        if take is not None:
            # Sampling a slice offset requires knowing the length.
            cuts = list(cuts)
            if take < len(cuts):
                first = rng.randint(0, len(cuts) - take)

        field_streams = self._open_field_streams(shard)
        emitted = 0
        for idx, (cut, *field_data) in enumerate(zip(cuts, *field_streams.values())):
            if idx < first:
                continue
            if emitted == take:
                break
            if emitted < skip:
                # Items consumed before the checkpoint.
                emitted += 1
                self._position_in_shard = emitted
                continue
            self._attach(cut, field_streams, field_data)
            cut.shard_origin = shard["cuts"]
            cut.shar_epoch = self.epoch
            if cut_map_fn is not None:
                cut = cut_map_fn(cut)
            emitted += 1
            self._position_in_shard = emitted
            yield cut

    # (state_dict key, attribute, default) for checkpointing.
    _STATE_FIELDS = (
        ("epoch", "epoch", 0), ("current_shard_idx", "_current_shard_idx", 0),
        ("position_in_shard", "_position_in_shard", 0), ("shard_order", "_shard_order", None))

    def state_dict(self) -> dict:
        return {key: getattr(self, attr, default) for key, attr, default in self._STATE_FIELDS}

    def load_state_dict(self, sd: dict) -> None:
        for key, attr, _ in self._STATE_FIELDS:
            setattr(self, attr, sd[key])
        self._restored = True

    def __len__(self) -> int:
        if self._len is None:
            self._len = sum(count_newlines_fast(p) for p in self.streams["cuts"])
        return self._len


def _jsonl_tar_adaptor(
    jsonl_iter: LazyJsonlIterator, field: str,
) -> Generator[Tuple[Optional[dict], Path], None, None]:
    """Adapt LazyJsonlIterator output to TarIterator's (item, path) shape."""
    for item in jsonl_iter:
        pseudo_path = Path(f"{item['cut_id']}.dummy")
        if field not in item:
            item = None  # placeholder
        else:
            item = item[field]
        yield item, pseudo_path
