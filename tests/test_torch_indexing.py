"""
The port's indexed manifests (``lhotse_tpu_torch/indexing.py``,
``LazyIndexedManifestIterator``, ``PartitionedIndexedIterator``, the indexed
reads of ``serialization.py`` and the chain's item-level shuffle) against
the JAX package on the same files: ``.idx`` bytes, permutations, records,
orders and state dicts are compared exactly.
"""
import json
import random
import warnings

import pytest

import lhotse_tpu as J
from lhotse_tpu import indexing as jidx
from lhotse_tpu.dataset import dataloading as jdl
from lhotse_tpu.lazy import LazyIndexedManifestIterator as JLazyIndexed
from lhotse_tpu.lazy import LazyIteratorChain as JChain
from lhotse_tpu.testing.dummies import DummyManifest as JDummyManifest
from lhotse_tpu_torch import indexing as pidx
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import dataloading as pdl
from lhotse_tpu_torch.lazy import LazyIndexedManifestIterator, LazyIteratorChain
from lhotse_tpu_torch.serialization import load_manifest_lazy

N_CUTS = 13


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """A 13-cut JSONL manifest and a 2-shard Shar dump (WAV recordings),
    both written by the JAX package, without their ``.idx`` files."""
    root = tmp_path_factory.mktemp("indexing")
    cuts = JDummyManifest(J.CutSet, begin_id=0, end_id=N_CUTS)
    cuts.to_file(root / "cuts.jsonl")
    small = JDummyManifest(J.CutSet, begin_id=0, end_id=5, with_data=True)
    for c in small:
        c.custom, c.features = {}, None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        small.to_shar(root / "shar", fields={"recording": "wav"}, shard_size=3,
                      compress_jsonl=False, create_index=False)
    return root


def _set_partition(monkeypatch, rank, world, worker, workers):
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("LHOTSE_USE_WORKER_PARTITION", "1")
    for m in (jdl, pdl):
        m.set_worker_info(m.WorkerInfo(id=worker, num_workers=workers, seed=0))


@pytest.fixture
def no_worker_info():
    yield
    jdl.set_worker_info(None)
    pdl.set_worker_info(None)


@pytest.mark.parametrize("kind", ["jsonl", "tar"])
def test_index_bytes_equal_jax(manifests, tmp_path, kind):
    data = manifests / ("cuts.jsonl" if kind == "jsonl" else "shar/recording.000000.tar")
    make = {"jsonl": (pidx.create_jsonl_index, jidx.create_jsonl_index),
            "tar": (pidx.create_tar_index, jidx.create_tar_index)}[kind]
    ours, theirs = tmp_path / "port.idx", tmp_path / "jax.idx"
    make[0](data, output_path=ours)
    make[1](data, output_path=theirs)
    assert ours.read_bytes() == theirs.read_bytes()
    assert (pidx.read_index(ours) == jidx.read_index(theirs)).all()
    assert pidx.index_exists(data, index_path=ours)
    assert not pidx.index_exists(data, index_path=tmp_path / "missing.idx")


def test_shar_index_directory_equal_jax(manifests, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    pidx.create_shar_index(manifests / "shar", output_dir=tmp_path / "port")
    jidx.create_shar_index(manifests / "shar", output_dir=tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 4
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("n,seed,shard_id,num_shards", [
    (1, 0, 0, 1), (2, 7, 0, 1), (5, 3, 0, 1), (17, 11, 0, 1), (100, 0, 1, 3), (1000, 42, 2, 4),
    (3, 1, 2, 4), (4097, 2**40 + 5, 0, 2)])
def test_lazy_shuffled_range_equals_jax(n, seed, shard_id, num_shards):
    """Sizes off a power of four cycle-walk; a shard past ``n`` is empty."""
    ours = pidx.LazyShuffledRange(n, seed, shard_id, num_shards)
    theirs = jidx.LazyShuffledRange(n, seed, shard_id, num_shards)
    assert len(ours) == len(theirs)
    assert [ours[i] for i in range(len(ours))] == [theirs[i] for i in range(len(theirs))]
    head = [next(ours) for _ in range(len(ours) // 2)]
    assert head == [next(theirs) for _ in range(len(head))]
    assert ours.state_dict() == theirs.state_dict()
    resumed = pidx.LazyShuffledRange(n, seed, shard_id, num_shards)
    resumed.load_state_dict(theirs.state_dict())
    assert list(resumed) == list(theirs)
    if num_shards == 1:
        assert sorted(pidx.LazyShuffledRange(n, seed)) == list(range(n))


def test_lazy_shuffled_range_refuses_other_topology():
    r = pidx.LazyShuffledRange(10, 0, 0, 2)
    with pytest.raises(ValueError, match="topology"):
        r.load_state_dict(jidx.LazyShuffledRange(10, 0, 1, 2).state_dict())


def test_indexed_readers_equal_jax(manifests):
    ours, theirs = pidx.IndexedJsonlReader(manifests / "cuts.jsonl"), jidx.IndexedJsonlReader(
        manifests / "cuts.jsonl")
    assert len(ours) == len(theirs) == N_CUTS
    assert [ours[i] for i in range(N_CUTS)] == [theirs[i] for i in range(N_CUTS)]
    assert ours[-1] == json.loads((manifests / "cuts.jsonl").read_text().splitlines()[-1])
    with pytest.raises(IndexError):
        ours[N_CUTS]
    tar = manifests / "shar" / "recording.000001.tar"
    ours, theirs = pidx.IndexedTarReader(tar), jidx.IndexedTarReader(tar)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        (a, a_path), (b, b_path) = ours[i], theirs[i]
        assert a_path == b_path and a.to_dict() == b.to_dict()
        assert ours.member_byte_range(i) == theirs.member_byte_range(i)


def _ids(items):
    return [c.id for c in items]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("grid", [(0, 1, 0, 1), (1, 2, 1, 2), (0, 1, 2, 3)])
def test_lazy_indexed_manifest_iterator_equals_jax(manifests, monkeypatch, no_worker_info,
                                                   shuffle, grid):
    """Order and state dicts, shuffled or not, in one (rank, worker) cell of
    a partition; a checkpoint taken mid-pass by either package resumes the
    other's iterator at the same item."""
    if grid != (0, 1, 0, 1):
        _set_partition(monkeypatch, *grid)
    path = manifests / "cuts.jsonl"
    ours = LazyIndexedManifestIterator(path, shuffle=shuffle, seed=5)
    theirs = JLazyIndexed(path, shuffle=shuffle, seed=5)
    assert len(ours) == len(theirs) == N_CUTS
    a, b = iter(ours), iter(theirs)
    head = [next(a).id for _ in range(2)]
    assert head == [next(b).id for _ in range(2)]
    assert ours.state_dict() == theirs.state_dict()
    resumed = LazyIndexedManifestIterator(path, shuffle=shuffle, seed=5)
    resumed.load_state_dict(json.loads(json.dumps(theirs.state_dict())))
    rest = _ids(b)
    assert _ids(a) == rest and _ids(resumed) == rest
    assert ours[4].to_dict() == theirs[4].to_dict()


def test_partition_grid_covers_every_item(manifests, monkeypatch, no_worker_info):
    all_ids = sorted(_ids(J.CutSet.from_file(manifests / "cuts.jsonl")))
    seen = []
    for rank in range(2):
        for worker in range(3):
            _set_partition(monkeypatch, rank, 2, worker, 3)
            seen += _ids(LazyIndexedManifestIterator(manifests / "cuts.jsonl", shuffle=True, seed=1))
    assert sorted(seen) == all_ids


def test_indexed_reads_of_serialization_equal_jax(manifests, tmp_path):
    """``from_jsonl_lazy(shuffle=True)``; ``load_manifest_lazy`` with
    ``indexed=True``, with an explicit ``index_path``, and with
    ``indexed=None`` over an existing sidecar."""
    path = manifests / "cuts.jsonl"
    ours, theirs = CutSet.from_jsonl_lazy(path, shuffle=True, seed=3), J.CutSet.from_jsonl_lazy(
        path, shuffle=True, seed=3)
    assert ours.is_indexed and ours.has_constant_time_access
    assert _ids(ours) == _ids(theirs) != sorted(_ids(theirs))
    idx = tmp_path / "elsewhere.idx"
    jidx.create_jsonl_index(path, output_path=idx)
    for kw in (dict(indexed=True), dict(indexed=True, shuffle=True, seed=9),
               dict(index_path=idx, shuffle=True, seed=2)):
        ours = load_manifest_lazy(path, **kw)
        assert isinstance(ours.data, LazyIndexedManifestIterator)
        assert _ids(ours) == _ids(J.serialization.load_manifest_lazy(path, **kw))
    copy = tmp_path / "copy.jsonl"
    copy.write_bytes(path.read_bytes())
    assert not isinstance(load_manifest_lazy(copy).data, LazyIndexedManifestIterator)
    jidx.create_jsonl_index(copy)
    assert isinstance(load_manifest_lazy(copy).data, LazyIndexedManifestIterator)
    assert isinstance(CutSet.from_file(copy).data, LazyIndexedManifestIterator)


def test_chain_item_shuffle_equals_jax(manifests, tmp_path):
    """``LazyIteratorChain(shuffle_iters=True)`` over indexed leaves
    shuffles items across the leaves, epoch after epoch, and resumes from
    the other package's checkpoint."""
    lines = (manifests / "cuts.jsonl").read_text().splitlines(keepends=True)
    paths = []
    for k, part in enumerate((lines[:5], lines[5:])):
        paths.append(tmp_path / f"part{k}.jsonl")
        paths[-1].write_text("".join(part))

    def chain(pkg):
        leaf, cls = (LazyIndexedManifestIterator, LazyIteratorChain) if pkg == "port" else (
            JLazyIndexed, JChain)
        return cls(*(leaf(p) for p in paths), shuffle_iters=True, seed=4)

    ours, theirs = chain("port"), chain("jax")
    assert ours.is_indexed and ours.has_constant_time_access
    all_ids = sorted(_ids(J.CutSet.from_file(manifests / "cuts.jsonl")))
    orders = []
    for _ in range(2):
        orders.append(_ids(theirs))
        assert _ids(ours) == orders[-1] and sorted(orders[-1]) == all_ids
    assert orders[0] != orders[1]
    it = iter(theirs)
    first = [next(it).id for _ in range(4)]
    resumed = chain("port")
    resumed.load_state_dict(json.loads(json.dumps(theirs.state_dict())))
    assert first + _ids(resumed) == first + _ids(it)
    assert ours[(1, 2)].id == theirs[(1, 2)].id and ours[7].id == theirs[7].id


def test_partitioned_indexed_iterator_equals_jax(monkeypatch, no_worker_info):
    for shuffle in (False, True):
        ours, theirs = pdl.PartitionedIndexedIterator(shuffle, seed=8), jdl.PartitionedIndexedIterator(
            shuffle, seed=8)
        assert list(ours.iterate(11, partition=(1, 3))) == list(theirs.iterate(11, partition=(1, 3)))
        a, b = ours.iterate(11, partition=(0, 2)), theirs.iterate(11, partition=(0, 2))
        assert [next(a) for _ in range(3)] == [next(b) for _ in range(3)]
        assert ours.state_dict() == theirs.state_dict()
        resumed = pdl.PartitionedIndexedIterator(shuffle, seed=0)
        resumed.load_state_dict(theirs.state_dict())
        assert list(resumed.iterate(11, partition=(0, 2))) == list(b)
        resumed.load_state_dict(theirs.state_dict())
        with pytest.raises(ValueError, match="topology"):
            list(resumed.iterate(11, partition=(1, 2)))
    _set_partition(monkeypatch, 1, 2, 0, 2)
    assert pdl.get_worker_partition() == jdl.get_worker_partition() == (2, 4)


def test_make_worker_init_fn_seeds_like_jax(monkeypatch):
    for key in ("LHOTSE_PROCESS_SEED", "RANK", "WORLD_SIZE", "LHOTSE_USE_WORKER_PARTITION"):
        # Set, then delete: the teardown then removes what worker_init_fn sets.
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    pdl.make_worker_init_fn(rank=1, world_size=2, seed=3)(2)
    ours = random.random()
    import os

    env = {k: os.environ[k] for k in ("LHOTSE_PROCESS_SEED", "RANK", "WORLD_SIZE")}
    jdl.make_worker_init_fn(rank=1, world_size=2, seed=3)(2)
    assert random.random() == ours and env == {"LHOTSE_PROCESS_SEED": "100203", "RANK": "1",
                                               "WORLD_SIZE": "2"}


def test_compressed_and_remote_paths_refuse(manifests, tmp_path):
    with pytest.raises(RuntimeError, match="compressed"):
        pidx.create_jsonl_index(tmp_path / "x.jsonl.gz")
    assert not pidx.supports_indexed_access("pipe:cat x.jsonl")
    # No I/O backend serves an https URL here: both packages raise the same.
    url = "https://example.invalid/cuts.jsonl.idx"
    with pytest.raises(RuntimeError, match="Couldn't find any applicable IOBackend") as ours:
        pidx.read_index(url)
    with pytest.raises(RuntimeError) as theirs:
        jidx.read_index(url)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(RuntimeError, match="uncompressed"):
        pidx.IndexedJsonlReader(tmp_path / "x.jsonl.gz")
