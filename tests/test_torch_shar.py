"""
The port's Shar format (``lhotse_tpu_torch/shar``, ``CutSet.from_shar`` and
``to_shar``), ``LazyCutMixer``'s indexed regime and the test dummies,
against the JAX package on the same cuts: a small FLAC corpus with
``lilcom_chunky`` features written by the JAX package.

Everything here runs the same numpy and C code on both sides, so it is
compared exactly: tar and ``.idx`` bytes, decompressed cut manifests,
audio with ``np.array_equal``, features decoded from the same bytes, cut
orders, ids and state dicts.
"""
import gzip
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

import lhotse_tpu as J
import lhotse_tpu.testing.dummies as JD
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.dataset import dataloading as jdl
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch import shar as PS
from lhotse_tpu_torch.cut import CutSet, MixedCut
from lhotse_tpu_torch.dataset import dataloading as pdl
from lhotse_tpu_torch.shar.readers import LazyIndexedSharIterator, LazySharIterator
from lhotse_tpu_torch.testing import dummies as PD
from lhotse_tpu_torch.utils import fix_random_seed

SR = 16000
N_CUTS = 10
FIELDS = {"recording": "flac", "features": "lilcom"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten FLAC tone bursts of 0.5-1.3 s with one supervision each, their
    features in a JAX-written ``lilcom_chunky`` archive, and a 3 x 2 s
    noise pool."""
    root = tmp_path_factory.mktemp("shar_corpus")
    rng = np.random.RandomState(1234)

    def burst(seconds):
        n = int(SR * seconds)
        t = np.arange(n) / SR
        f0 = rng.uniform(80, 220)
        wave = sum(np.sin(2 * np.pi * f0 * (h + 1) * t) / (h + 1) for h in range(4)) * 0.2
        return (wave + rng.randn(n) * 0.01).astype(np.float32)

    cuts = []
    for i in range(N_CUTS):
        jwrite_flac(str(root / f"utt{i:02d}.flac"), burst(float(rng.uniform(0.5, 1.3))), SR)
        cut = J.Recording.from_file(root / f"utt{i:02d}.flac").to_cut()
        cut.supervisions.append(J.SupervisionSegment(
            id=f"sup{i:02d}", recording_id=cut.recording_id, start=0.0, duration=cut.duration,
            text="synthetic"))
        cuts.append(cut)
    J.CutSet.from_cuts(cuts).compute_and_store_features(
        J.Fbank(), root / "feats", progress_bar=False).to_file(root / "cuts.jsonl")
    noise = []
    for i in range(3):
        jwrite_flac(str(root / f"noise{i:02d}.flac"), burst(2.0), SR)
        noise.append(J.Recording.from_file(root / f"noise{i:02d}.flac").to_cut())
    J.CutSet.from_cuts(noise).to_file(root / "noise.jsonl")
    return root


def _cls(pkg):
    return CutSet if pkg == "port" else J.CutSet


def _export(corpus, pkg, out: Path, **kw):
    kw = {"shard_size": 3, "compress_jsonl": False, **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _cls(pkg).from_file(corpus / "cuts.jsonl").to_shar(out, fields=FIELDS, **kw)


@pytest.fixture(scope="module")
def shards(corpus, tmp_path_factory):
    """``to_shar`` of the corpus by each package: 4 uncompressed, indexed shards."""
    out = {}
    for pkg in ("port", "jax"):
        out[pkg] = tmp_path_factory.mktemp(f"shar_{pkg}")
        _export(corpus, pkg, out[pkg])
    return out


def _jsonl_lines(path: Path) -> list:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("compress_jsonl", [False, True])
def test_to_shar_bytes_equal_jax(corpus, tmp_path, compress_jsonl):
    paths = {pkg: _export(corpus, pkg, tmp_path / pkg, compress_jsonl=compress_jsonl)
             for pkg in ("port", "jax")}
    assert set(paths["port"]) == {"cuts", "recording", "features"}
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len([n for n in names if n.endswith(".tar")]) == 8
    assert sum(n.endswith(".idx") for n in names) == (8 if compress_jsonl else 12)
    for name in names:
        ours, theirs = tmp_path / "port" / name, tmp_path / "jax" / name
        if ".jsonl" in name and not name.endswith(".idx"):
            assert _jsonl_lines(ours) == _jsonl_lines(theirs), name
        else:
            assert ours.read_bytes() == theirs.read_bytes(), name


def test_to_shar_over_processes_equals_one_process(corpus, tmp_path):
    """``num_jobs=2``: ``split_lazy`` chunks, one spawned process per shard."""
    one = _export(corpus, "port", tmp_path / "one")
    two = _export(corpus, "port", tmp_path / "two", num_jobs=2)
    assert {k: [Path(p).name for p in v] for k, v in one.items()} == {
        k: [Path(p).name for p in v] for k, v in two.items()}
    for name in (Path(p).name for v in one.values() for p in v):
        a, b = tmp_path / "one" / name, tmp_path / "two" / name
        if name.endswith(".jsonl"):
            assert _jsonl_lines(a) == _jsonl_lines(b)
        else:
            assert a.read_bytes() == b.read_bytes(), name
    chunks = CutSet.from_file(corpus / "cuts.jsonl").split_lazy(tmp_path / "split", chunk_size=4)
    jchunks = J.CutSet.from_file(corpus / "cuts.jsonl").split_lazy(tmp_path / "jsplit", chunk_size=4)
    assert [[c.id for c in s] for s in chunks] == [[c.id for c in s] for s in jchunks]


def _read(pkg, shar_dir, **kw):
    return _cls(pkg).from_shar(in_dir=shar_dir, **kw)


def _assert_cuts_equal(ours, theirs):
    assert [c.id for c in ours] == [c.id for c in theirs]
    for a, b in zip(ours, theirs):
        da, db = a.to_dict(), b.to_dict()
        assert da == db, a.id
        audio = a.load_audio()
        assert audio.dtype == np.float32 and np.array_equal(audio, b.load_audio())
        assert np.array_equal(a.load_features(), b.load_features())


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("mode", [
    dict(indexed=False), dict(indexed=False, shuffle_shards=True, seed=3),
    dict(indexed=True), dict(indexed=True, shuffle_shards=True, seed=3),
    dict(indexed=True, shuffle_shards=True, seed=3, lazy=True)],
    ids=["streaming", "streaming-shuffled", "indexed", "indexed-shuffled", "pointers"])
def test_each_package_reads_the_others_shards(shards, writer, mode):
    ours, theirs = list(_read("port", shards[writer], **mode)), list(_read("jax", shards[writer], **mode))
    assert len(ours) == N_CUTS
    _assert_cuts_equal(ours, theirs)
    if mode.get("shuffle_shards"):
        assert [c.id for c in ours] != sorted(c.id for c in ours)
    if mode.get("lazy"):
        assert all(c.recording.sources[0].type == "shar_ptr" for c in ours)
        assert all(c.features.storage_type == "shar_ptr_array" for c in ours)
        PS.lazy_pointer.close_all()


def test_audio_equals_the_flac_source(corpus, shards):
    sources = {c.id: c for c in CutSet.from_file(corpus / "cuts.jsonl")}
    for cut in _read("port", shards["port"]):
        src = sources[cut.id]
        assert np.array_equal(cut.load_audio(), src.load_audio())
        assert np.abs(cut.load_features() - src.load_features()).max() <= 2.0**-5


def test_from_shar_picks_the_reader(corpus, shards, tmp_path):
    assert isinstance(_read("port", shards["port"]).data, LazyIndexedSharIterator)
    assert _read("port", shards["port"]).has_constant_time_access
    gz = tmp_path / "gz"
    _export(corpus, "port", gz, compress_jsonl=True)
    assert isinstance(_read("port", gz).data, LazySharIterator)
    assert not LazyIndexedSharIterator.supports_configuration(in_dir=gz)
    with pytest.raises(ValueError, match="contradictory"):
        _read("port", shards["port"], indexed=False, index_path=shards["port"])
    fields = {"cuts": sorted(str(p) for p in shards["port"].glob("cuts.*.jsonl")),
              "recording": sorted(str(p) for p in shards["port"].glob("recording.*.tar"))}
    ours = CutSet.from_shar(fields=fields, indexed=False)
    theirs = J.CutSet.from_shar(fields=fields, indexed=False)
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    # A field left out stays a placeholder: its data was never attached.
    assert all(c.features.is_placeholder for c in ours)


def test_indexed_random_access_equals_jax(shards):
    ours, theirs = _read("port", shards["jax"], indexed=True), _read("jax", shards["jax"], indexed=True)
    for token in (0, 4, 9, -1, (7, 2)):
        a, b = ours.data[token], theirs.data[token]
        assert a.to_dict() == b.to_dict() and np.array_equal(a.load_audio(), b.load_audio())
    with pytest.raises(IndexError):
        ours.data[N_CUTS]


@pytest.mark.parametrize("indexed", [False, True])
def test_checkpoint_resume_across_packages(shards, indexed):
    """A checkpoint taken mid-epoch by one package's reader resumes the
    other's at the next cut (JSON round trip included)."""
    kw = dict(indexed=indexed, shuffle_shards=True, seed=11)
    for src, dst in (("jax", "port"), ("port", "jax")):
        reader = _read(src, shards["port"], **kw)
        it = iter(reader)
        head = [next(it).id for _ in range(4)]
        state = json.loads(json.dumps(reader.data.state_dict(), default=str))
        rest = [c.id for c in it]
        resumed = _read(dst, shards["port"], **kw)
        resumed.data.load_state_dict(state)
        assert [c.id for c in resumed] == rest and len(head + rest) == N_CUTS


def test_streaming_epochs_reshuffle_like_jax(shards):
    ours = _read("port", shards["port"], indexed=False, shuffle_shards=True, seed=2)
    theirs = _read("jax", shards["port"], indexed=False, shuffle_shards=True, seed=2)
    orders = []
    for epoch in range(3):
        cuts = list(ours)
        orders.append([c.id for c in cuts])
        assert orders[-1] == [c.id for c in theirs]
        assert [c.shar_epoch for c in cuts] == [epoch] * N_CUTS
    assert len({tuple(o) for o in orders}) > 1
    ours.data.set_epoch(0)
    theirs.data.set_epoch(0)
    assert [c.id for c in ours] == [c.id for c in theirs] == orders[0]


def _set_replica(monkeypatch, rank, world, worker, workers):
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    for m in (jdl, pdl):
        m.set_worker_info(m.WorkerInfo(id=worker, num_workers=workers, seed=0))


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("world_size,num_workers", [(2, 2), (4, 1), (1, 4), (2, 1)])
def test_rank_worker_grid_equals_jax(shards, monkeypatch, indexed, world_size, num_workers):
    """``split_for_dataloading=True``: every (rank, worker) replica reads
    what the JAX package's replica reads; jointly every cut once."""
    seen = []
    try:
        for rank in range(world_size):
            for worker in range(num_workers):
                _set_replica(monkeypatch, rank, world_size, worker, num_workers)
                kw = dict(indexed=indexed, split_for_dataloading=True, shuffle_shards=True, seed=0)
                ids = [c.id for c in _read("port", shards["port"], **kw)]
                assert ids == [c.id for c in _read("jax", shards["port"], **kw)]
                seen += ids
    finally:
        jdl.set_worker_info(None)
        pdl.set_worker_info(None)
    assert sorted(seen) == sorted(c.id for c in _read("jax", shards["port"]))


def _mixer(corpus, pkg, shard_dir, seed=5):
    cls = _cls(pkg)
    return cls.from_shar(in_dir=shard_dir, indexed=True, shuffle_shards=True, seed=3).mix(
        cls.from_jsonl_lazy(corpus / "noise.jsonl", shuffle=True, seed=0), snr=(5, 15),
        mix_prob=0.6, seed=seed, random_mix_offset=True, preserve_id="left")


def _mix_signature(cut):
    """A mixed cut without the ids that ``uuid4`` gives truncated noise cuts:
    which noise, where it was cut, its offset and SNR."""
    if not isinstance(cut, (MixedCut, J.MixedCut)):
        return cut.id, cut.start, cut.duration
    return cut.id, [(t.cut.recording_id, t.cut.start, t.cut.duration, t.offset, t.snr)
                    for t in cut.tracks]


def test_lazy_cut_mixer_indexed_regime_equals_jax(corpus, shards):
    """Indexed cuts and indexed noise: each mixed cut is a function of the
    iteration seed and the cut's graph token, so ``[token]`` rebuilds it, and
    a checkpoint of either package resumes the other's mixer."""
    ours, theirs = _mixer(corpus, "port", shards["port"]), _mixer(corpus, "jax", shards["port"])
    assert ours.data.has_constant_time_access and ours.data.is_checkpointable
    for epoch in range(2):
        fix_random_seed(epoch)
        a = list(ours)
        jfix(epoch)
        b = list(theirs)
        assert [c.to_dict() for c in a] == [c.to_dict() for c in b]
        assert 0 < sum(isinstance(c, MixedCut) for c in a) < N_CUTS
    assert np.array_equal(a[0].load_audio(), b[0].load_audio())
    token = a[3]._graph_origin if hasattr(a[3], "_graph_origin") else None
    assert token is not None and ours.data[token].to_dict() == a[3].to_dict()
    for src, dst in ((theirs, "port"), (ours, "jax")):
        it = iter(src)
        head = [_mix_signature(next(it)) for _ in range(4)]
        state = json.loads(json.dumps(src.data.state_dict(), default=str))
        rest = [_mix_signature(c) for c in it]
        resumed = _mixer(corpus, dst, shards["port"])
        resumed.data.load_state_dict(state)
        assert [_mix_signature(c) for c in resumed] == rest and len(head + rest) == N_CUTS
    with pytest.raises(TypeError, match="constant-time"):
        CutSet.from_file(corpus / "cuts.jsonl").mix(CutSet.from_file(corpus / "noise.jsonl")).data[0]


def test_placeholders_raise(corpus, tmp_path):
    from lhotse_tpu.shar import to_shar_placeholder as jto_shar_placeholder
    from lhotse_tpu_torch.shar import to_shar_placeholder

    cut, jcut = CutSet.from_file(corpus / "cuts.jsonl")[0], J.CutSet.from_file(corpus / "cuts.jsonl")[0]
    rec = to_shar_placeholder(cut.recording, cut)
    assert rec.is_placeholder and rec.to_dict() == jto_shar_placeholder(jcut.recording, jcut).to_dict()
    with pytest.raises(RuntimeError, match="Shar placeholder"):
        rec.load_audio()
    feats = to_shar_placeholder(cut.features, cut)
    assert feats.to_dict() == jto_shar_placeholder(jcut.features, jcut).to_dict()
    with pytest.raises(RuntimeError, match="Shar placeholder"):
        feats.load()
    with pytest.raises(NotImplementedError, match="opus"):
        PS.AudioTarWriter(str(tmp_path / "a.%06d.tar"), format="opus")


def _dummy_pairs():
    """(name, port thunk, JAX thunk) for every factory."""
    names = [
        ("dummy_audio_source", dict(with_data=True)), ("dummy_audio_source", dict(format="flac", with_data=True)),
        ("dummy_audio_source", {}), ("dummy_recording", dict(unique_id=3, with_data=True)),
        ("dummy_recording", dict(unique_id=4, with_data=True, source_format="flac")),
        ("dummy_multi_channel_recording", dict(unique_id=5, with_data=True)),
        ("dummy_multi_channel_recording", dict(unique_id=6, source_per_channel=True)),
        ("dummy_supervision", dict(unique_id=7)), ("dummy_features", dict(unique_id=8)),
        ("dummy_features", dict(unique_id=9, with_data=True)),
        ("dummy_in_memory_features", dict(unique_id=10)),
        ("dummy_multi_channel_features", dict(unique_id=11)), ("dummy_array", {}),
        ("dummy_temporal_array", {}), ("dummy_temporal_array_uint8", {}),
        ("dummy_cut", dict(unique_id=12)), ("dummy_cut", dict(unique_id=13, with_data=True))]
    return [(f"{n}-{i}", n, kw) for i, (n, kw) in enumerate(names)]


@pytest.mark.parametrize("case,name,kwargs", _dummy_pairs(), ids=[c for c, _, _ in _dummy_pairs()])
def test_dummy_factories_equal_jax(case, name, kwargs):
    np.random.seed(0)
    ours = getattr(PD, name)(**kwargs)
    np.random.seed(0)
    theirs = getattr(JD, name)(**kwargs)
    assert ours.to_dict() == theirs.to_dict()
    if hasattr(ours, "load_audio") and kwargs.get("with_data"):
        assert np.array_equal(ours.load_audio(), theirs.load_audio())


def test_dummy_manifests_equal_jax(tmp_path):
    np.random.seed(0)
    ours = PD.DummyManifest(CutSet, begin_id=0, end_id=3, with_data=True)
    np.random.seed(0)
    theirs = JD.DummyManifest(J.CutSet, begin_id=0, end_id=3, with_data=True)
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    feats = PD.DummyManifest(PD.FeatureSet, begin_id=2, end_id=5)
    assert [f.to_dict() for f in feats] == [f.to_dict() for f in JD.DummyManifest(
        JD.FeatureSet, begin_id=2, end_id=5)]
    assert PD.dummy_alignment("abcdefg") == JD.dummy_alignment("abcdefg")
    sup = PD.remove_spaces_from_segment_text(PD.dummy_supervision(1, text="a b c"))
    assert sup.text == "abc"
    with PD.as_lazy(PD.DummyManifest(CutSet, begin_id=0, end_id=4)) as lazy:
        assert lazy.is_lazy and [c.id for c in lazy] == [f"dummy-mono-cut-{i:04d}" for i in range(4)]
    with pytest.raises(NotImplementedError, match="MultiCut"):
        PD.dummy_multi_cut(0)
    with pytest.raises(ValueError, match="cannot fabricate"):
        PD.DummyManifest(dict, begin_id=0, end_id=1)
