"""
The port's index packs (``lhotse_tpu_torch/index_pack.py``) and the packed
lazy iterator (``lhotse_tpu_torch/packed_lazy.py``) held to the JAX
package's: every case of ``tests/test_index_pack.py`` and
``tests/test_index_pack_corruption.py`` runs through both packages; packs
written by the two are byte-equal and each package opens the other's; the
sequential and shuffled orders, records and state dicts are equal for the
same seed, and resumes are exact, also across the packages.
"""
import copy
import json
import pickle
import struct

import pytest
from click.testing import CliRunner

import lhotse_tpu as J
from lhotse_tpu import index_pack as jpack
from lhotse_tpu import indexing as jidx
from lhotse_tpu import packed_lazy as jlazy
from lhotse_tpu.cut import MonoCut as JMonoCut
from lhotse_tpu_torch import index_pack as ppack
from lhotse_tpu_torch import indexing as pidx
from lhotse_tpu_torch import packed_lazy as plazy
from lhotse_tpu_torch.cut import CutSet, MonoCut


class _Side:
    def __init__(self, jax: bool):
        self.pack = jpack if jax else ppack
        self.lazy = jlazy if jax else plazy
        self.idx = jidx if jax else pidx
        self.CutSet = J.CutSet if jax else CutSet
        self.MonoCut = JMonoCut if jax else MonoCut
        self.jax = jax

    def cli(self):
        if self.jax:
            from lhotse_tpu.bin.lhotse_tpu import cli
        else:
            from lhotse_tpu_torch.bin.lhotse_tpu_torch import cli
        return cli

    def sampler(self, cuts):
        if self.jax:
            from lhotse_tpu.dataset import DynamicCutSampler
        else:
            from lhotse_tpu_torch.dataset import DynamicCutSampler
        return DynamicCutSampler(cuts, max_cuts=4, world_size=1, rank=0)


SIDES = {"jax": _Side(True), "port": _Side(False)}
SPEC = "cuts-{000..002}.jsonl"
KEY = jpack.index_pack_collection_key(role="records", kind="json-lines", source_spec=SPEC)
ALL_IDS = [f"cut-{i:04d}" for i in range(30)]


def make_shards(side, root, num_shards=3, cuts_per_shard=10):
    root.mkdir(parents=True, exist_ok=True)
    paths, idx = [], 0
    for s in range(num_shards):
        cuts = side.CutSet.from_cuts(
            side.MonoCut(id=f"cut-{idx + i:04d}", start=0.0, duration=1.0 + 0.1 * i, channel=0,
                         supervisions=[])
            for i in range(cuts_per_shard))
        idx += cuts_per_shard
        p = root / f"cuts-{s:03d}.jsonl"
        cuts.to_file(p)
        side.idx.create_jsonl_index(p)
        paths.append(str(p))
    return paths


def _write(side, out, paths, spec=SPEC, **kw):
    return side.pack.write_index_pack(out, [side.pack.IndexPackCollectionSpec(
        role="records", kind="json-lines", source_spec=spec, paths=tuple(paths))], **kw)


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


@pytest.fixture
def pack_path(side, tmp_path):
    return _write(side, tmp_path / "dataset.idxpack", make_shards(side, tmp_path))


# -- tests/test_index_pack.py, through each package -------------------------------------


def test_catalog_and_locate(side, pack_path):
    with side.pack.IndexPack(pack_path) as pack:
        col = pack.collection(KEY)
        assert len(col) == 30 and col.sequence_count == 3 and col.shard_length(0) == 10
        loc = col.locate(17)
        assert (loc.shard_index, loc.local_index) == (1, 7)
        assert loc.path.endswith("cuts-001.jsonl")
        with open(loc.path, "rb") as f:
            f.seek(loc.start)
            assert json.loads(f.read(loc.end - loc.start))["id"] == "cut-0017"


def test_crc_verification(side, pack_path):
    with side.pack.IndexPack(pack_path) as pack:
        for seg in range(pack.num_segments):
            pack.verify_segment(seg)


def test_unknown_collection(side, pack_path):
    with side.pack.IndexPack(pack_path) as pack:
        with pytest.raises(KeyError):
            pack.collection(b"\0" * 32)


def test_pickle_roundtrip(side, pack_path):
    pack2 = pickle.loads(pickle.dumps(side.pack.IndexPack(pack_path)))
    assert len(pack2.collection(KEY)) == 30
    assert pack2.collection(KEY).locate(5).local_index == 5


def test_overwrite_protection(side, pack_path, tmp_path):
    paths = make_shards(side, tmp_path / "other", 1, 2)
    with pytest.raises(FileExistsError):
        _write(side, pack_path, paths, spec="x")
    _write(side, pack_path, paths, spec="x", overwrite=True)


def test_corrupt_sidecar_rejected(side, tmp_path):
    paths = make_shards(side, tmp_path, 1, 3)
    idx = tmp_path / "cuts-000.jsonl.idx"
    data = bytearray(idx.read_bytes())
    data[0:16] = struct.pack("<QQ", 100, 50)
    idx.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="Non-monotonic"):
        _write(side, tmp_path / "bad.idxpack", paths, spec="y")


def test_sequential_iteration(side, pack_path):
    it = side.lazy.LazyPackedManifestIterator(pack_path, KEY)
    assert it.has_constant_time_access
    assert [c.id for c in it] == ALL_IDS


def test_random_access_tokens(side, pack_path):
    it = side.lazy.LazyPackedManifestIterator(pack_path, KEY)
    assert it[17].id == it[(1, 7)].id == "cut-0017"
    assert it[-1].id == "cut-0029"


def test_shuffled_deterministic_and_complete(side, pack_path):
    def order(seed):
        return [c.id for c in side.lazy.LazyPackedManifestIterator(
            pack_path, KEY, shuffle_shards=True, seed=seed)]

    a = order(3)
    assert a == order(3) and sorted(a) == ALL_IDS and order(4) != a


def test_checkpoint_resume_sequential(side, pack_path):
    it = side.lazy.LazyPackedManifestIterator(pack_path, KEY)
    gen = iter(it)
    first = [next(gen).id for _ in range(13)]
    it2 = side.lazy.LazyPackedManifestIterator(pack_path, KEY)
    it2.load_state_dict(it.state_dict())
    assert first + [c.id for c in it2] == ALL_IDS


def test_checkpoint_resume_shuffled(side, pack_path):
    make = lambda: side.lazy.LazyPackedManifestIterator(  # noqa: E731
        pack_path, KEY, shuffle_shards=True, seed=7)
    all_ids = [c.id for c in make()]
    it2 = make()
    gen = iter(it2)
    first = [next(gen).id for _ in range(11)]
    it3 = make()
    it3.load_state_dict(it2.state_dict())
    assert first + [c.id for c in it3] == all_ids


def test_cutset_over_pack_with_sampler(side, pack_path):
    cuts = side.CutSet(side.lazy.LazyPackedManifestIterator(pack_path, KEY))
    assert cuts.has_constant_time_access
    assert sum(len(b) for b in side.sampler(cuts)) == 30


def test_verify_all_segments_and_cli(side, tmp_path):
    out = _write(side, tmp_path / "v.idxpack", make_shards(side, tmp_path))
    assert side.pack.IndexPack(out).verify() == 3
    res = CliRunner().invoke(side.cli(), ["index", "verify-pack", str(out)])
    assert res.exit_code == 0 and "OK (3 segments)" in res.output
    raw = bytearray(out.read_bytes())
    raw[-5] ^= 0xFF
    out.write_bytes(bytes(raw))
    res = CliRunner().invoke(side.cli(), ["index", "verify-pack", str(out)])
    assert "Verification failed" in res.output


# -- tests/test_index_pack_corruption.py, through each package --------------------------

CKEY = jpack.index_pack_collection_key(role="records", kind="json-lines", source_spec="spec")


@pytest.fixture
def small_pack(side, tmp_path):
    paths = []
    for s in range(2):
        cuts = side.CutSet.from_cuts(
            side.MonoCut(id=f"c{s}-{i}", start=0.0, duration=1.0, channel=0, supervisions=[])
            for i in range(8))
        p = tmp_path / f"cuts-{s}.jsonl"
        cuts.to_file(p)
        side.idx.create_jsonl_index(p)
        paths.append(str(p))
    return _write(side, tmp_path / "data.idxpack", paths, spec="spec")


def _flip_byte(path, position):
    with open(path, "r+b") as f:
        f.seek(position)
        b = f.read(1)
        f.seek(position)
        f.write(bytes([b[0] ^ 0xFF]))


def test_fresh_pack_verifies(side, small_pack):
    with side.pack.IndexPack(small_pack) as pack:
        for seg in range(pack.num_segments):
            pack.verify_segment(seg)


def test_flipped_offsets_byte_fails_crc(side, small_pack):
    with side.pack.IndexPack(small_pack) as pack:
        seg = pack._segment(0)
        pos = seg.offsets_pos + seg.offsets_size // 2
    _flip_byte(small_pack, pos)
    with side.pack.IndexPack(small_pack) as pack:
        with pytest.raises(ValueError, match="CRC mismatch"):
            pack.verify_segment(0)
        pack.verify_segment(1)


def test_corrupt_header_magic_rejected(side, small_pack):
    _flip_byte(small_pack, 0)
    with pytest.raises(ValueError, match="magic"):
        with side.pack.IndexPack(small_pack) as pack:
            pack.collection(CKEY).locate(0)


def test_truncated_pack_rejected(side, small_pack):
    size = small_pack.stat().st_size
    with open(small_pack, "r+b") as f:
        f.truncate(size // 2)
    with pytest.raises(Exception):
        with side.pack.IndexPack(small_pack) as pack:
            col = pack.collection(CKEY)
            for i in range(len(col)):
                col.locate(i)
            for seg in range(pack.num_segments):
                pack.verify_segment(seg)


def test_file_replaced_after_open_detected(side, small_pack):
    pack = side.pack.IndexPack(small_pack)
    pack.collection(CKEY).locate(3)
    state = pickle.dumps(pack)
    pack.close()
    with open(small_pack, "ab") as f:
        f.write(b"garbage appended after the pack was built")
    revived = pickle.loads(state)
    with pytest.raises(RuntimeError, match="changed after it was opened"):
        revived.collection(CKEY).locate(3)


def test_locate_out_of_range(side, small_pack):
    with side.pack.IndexPack(small_pack) as pack:
        col = pack.collection(CKEY)
        with pytest.raises(IndexError):
            col.locate(len(col))
        with pytest.raises(IndexError):
            col.locate_in_shard(99, 0)


# -- across the packages -----------------------------------------------------------------


@pytest.fixture
def both_packs(tmp_path):
    """The same shards, written by the JAX package, packed by each."""
    paths = make_shards(SIDES["jax"], tmp_path / "shards")
    packs = {name: _write(side, tmp_path / f"{name}.idxpack", paths)
             for name, side in SIDES.items()}
    return paths, packs


def test_packs_byte_equal(both_packs):
    _, packs = both_packs
    assert packs["port"].read_bytes() == packs["jax"].read_bytes()
    assert ppack.index_pack_collection_key("records", "json-lines", {"b": [1, 2], "a": "x"}) == \
        jpack.index_pack_collection_key("records", "json-lines", {"a": "x", "b": [1, 2]})


@pytest.mark.parametrize("reader,writer", [("port", "jax"), ("jax", "port")])
def test_each_opens_the_others_pack(both_packs, reader, writer):
    _, packs = both_packs
    with SIDES[reader].pack.IndexPack(packs[writer]) as pack:
        assert pack.verify() == 3
        col = pack.collection(KEY)
        assert [(loc.path, loc.start, loc.end) for loc in map(col.locate, range(30))] == [
            (loc.path, loc.start, loc.end)
            for loc in map(SIDES[writer].pack.IndexPack(packs[writer]).collection(KEY).locate,
                           range(30))]


@pytest.mark.parametrize("shuffle", [False, True])
def test_orders_and_resume_equal_across_packages(both_packs, shuffle):
    """Same order, records and state dicts for the same seed; a port
    iterator resumes from the JAX iterator's state dict."""
    _, packs = both_packs
    make = {name: (lambda side=side: side.lazy.LazyPackedManifestIterator(
        packs["jax"], KEY, shuffle_shards=shuffle, seed=5)) for name, side in SIDES.items()}
    theirs = [c.to_dict() for c in make["jax"]()]
    assert [c.to_dict() for c in make["port"]()] == theirs
    it = make["jax"]()
    gen = iter(it)
    first = [next(gen).id for _ in range(9)]
    port_it = make["port"]()
    gen = iter(port_it)
    assert [next(gen).id for _ in range(9)] == first
    assert port_it.state_dict() == it.state_dict()
    resumed = make["port"]()
    resumed.load_state_dict(copy.deepcopy(it.state_dict()))
    assert first + [c.id for c in resumed] == [c["id"] for c in theirs]


def test_worker_partitions_equal_across_packages(both_packs, monkeypatch):
    from lhotse_tpu.dataset import dataloading as jdl
    from lhotse_tpu_torch.dataset import dataloading as pdl

    _, packs = both_packs
    monkeypatch.setenv("LHOTSE_USE_WORKER_PARTITION", "1")
    try:
        for worker in range(2):
            for m in (jdl, pdl):
                m.set_worker_info(m.WorkerInfo(id=worker, num_workers=2, seed=0))
            for shuffle in (False, True):
                orders = [[c.id for c in side.lazy.LazyPackedManifestIterator(
                    packs["port"], KEY, shuffle_shards=shuffle, seed=1)]
                    for side in SIDES.values()]
                assert orders[0] == orders[1] and len(orders[0]) == 15
    finally:
        jdl.set_worker_info(None)
        pdl.set_worker_info(None)


def test_sidecar_older_than_source_refused(tmp_path):
    import os

    paths = make_shards(SIDES["port"], tmp_path, 1, 3)
    stat = os.stat(paths[0])
    os.utime(paths[0] + ".idx", ns=(stat.st_atime_ns, stat.st_mtime_ns - 10**9))
    for side in SIDES.values():
        with pytest.raises(ValueError, match="newer than index sidecar"):
            _write(side, tmp_path / f"{side.jax}.idxpack", paths, spec="z")
