"""
The port's WebDataset tars (``lhotse_tpu_torch/dataset/webdataset.py``)
held to the JAX package's: every case of ``tests/test_webdataset.py`` runs
through both packages; tars written from the same manifest are byte-equal
(FLAC and WAV audio, stored features), each package reads the other's, and
cuts come back with equal dicts and ``np.array_equal`` audio, also through
``pipe:cat`` shards. The shard shufflers and ``ShardWriter`` agree too.
"""
import pickle
from collections import Counter

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset import webdataset as jwds
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import webdataset as pwds

SR = 16000
WDS = {"jax": jwds, "port": pwds}
CUTSETS = {"jax": J.CutSet, "port": CutSet}


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Six 1 s noise recordings with fbank features in a lilcom_chunky
    archive, written by the JAX package."""
    d = tmp_path_factory.mktemp("wds_src")
    rng = np.random.RandomState(0)
    cuts = []
    for i in range(6):
        p = d / f"r{i}.wav"
        write_wav(str(p), (rng.randn(SR) * 0.1).astype(np.float32), SR)
        cuts.append(J.Recording.from_file(p).to_cut())
    with J.LilcomChunkyWriter(d / "feats") as st:
        cuts = J.CutSet.from_cuts(c.compute_and_store_features(J.Fbank(), st) for c in cuts)
    cuts.to_file(d / "cuts.jsonl")
    return d / "cuts.jsonl"


@pytest.fixture(params=sorted(WDS))
def package(request):
    return request.param


def _cuts(package, manifest):
    return CUTSETS[package].from_file(manifest)


# -- tests/test_webdataset.py, through each package --------------------------------------


def test_export_import_roundtrip(package, manifest, tmp_path):
    cuts = _cuts(package, manifest)
    n = WDS[package].export_to_webdataset(cuts, str(tmp_path / "all.tar"), audio_format="wav",
                                          verbose=False)
    assert n == 0
    back = list(CUTSETS[package].from_webdataset(str(tmp_path / "all.tar")))
    assert [c.id for c in back] == [c.id for c in cuts]
    np.testing.assert_allclose(back[0].load_audio(), cuts[0].load_audio(), atol=1.0 / 32768)
    assert np.abs(back[0].load_features() - cuts[0].load_features()).max() <= 2**-5


def test_sharded_export(package, manifest, tmp_path):
    cuts = _cuts(package, manifest)
    n = WDS[package].export_to_webdataset(cuts, str(tmp_path / "shard-%06d.tar"), shard_size=2,
                                          audio_format="wav", verbose=False)
    assert n == 3
    back = list(CUTSETS[package].from_webdataset(
        [str(tmp_path / f"shard-{i:06d}.tar") for i in range(3)]))
    assert sorted(c.id for c in back) == sorted(c.id for c in cuts)
    assert all(c.shard_origin.endswith(".tar") for c in back)


def test_shuffle_shards_epoch(package, manifest, tmp_path):
    WDS[package].export_to_webdataset(_cuts(package, manifest), str(tmp_path / "shard-%06d.tar"),
                                      shard_size=1, audio_format="wav", verbose=False)
    it = WDS[package].LazyWebdatasetIterator(
        [str(tmp_path / f"shard-{i:06d}.tar") for i in range(6)], shuffle_shards=True, epoch=0)
    order0 = [c.id for c in it]
    it.set_epoch(1)
    order1 = [c.id for c in it]
    assert sorted(order0) == sorted(order1) and order0 != order1


def test_webdataset_deduplicates_data_in_ddp(package, manifest, tmp_path, monkeypatch):
    (tmp_path / "wds").mkdir()
    WDS[package].export_to_webdataset(_cuts(package, manifest),
                                      str(tmp_path / "wds" / "shard-%06d.tar"), shard_size=2,
                                      audio_format="wav", verbose=False)
    shards = sorted(str(p) for p in (tmp_path / "wds").glob("*.tar"))
    assert len(shards) == 3
    seen = Counter()
    for rank in range(2):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", "2")
        for c in CUTSETS[package].from_webdataset(shards, split_by_node=True,
                                                  split_by_worker=False):
            seen[c.id] += 1
            assert c.load_audio() is not None
    assert set(seen) == {c.id for c in _cuts(package, manifest)}
    assert all(v == 1 for v in seen.values())


# -- across the packages -----------------------------------------------------------------


def _export_both(manifest, tmp_path, audio_format, shard_size=2):
    out = {}
    for name, wds in WDS.items():
        (tmp_path / name).mkdir()
        n = wds.export_to_webdataset(_cuts(name, manifest), str(tmp_path / name / "s-%06d.tar"),
                                     shard_size=shard_size, audio_format=audio_format,
                                     verbose=False)
        out[name] = [tmp_path / name / f"s-{i:06d}.tar" for i in range(n)]
    return out


@pytest.mark.parametrize("audio_format", ["flac", "wav"])
def test_tars_byte_equal(manifest, tmp_path, audio_format):
    shards = _export_both(manifest, tmp_path, audio_format)
    assert len(shards["port"]) == len(shards["jax"]) == 3
    for ours, theirs in zip(shards["port"], shards["jax"]):
        assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("pipe", [False, True])
@pytest.mark.parametrize("reader", sorted(WDS))
def test_read_back_equal(manifest, tmp_path, reader, pipe):
    """Each package reads the other's FLAC shards (through ``pipe:cat``
    too): equal dicts, lossless audio, equal features."""
    shards = _export_both(manifest, tmp_path, "flac")
    writer = "jax" if reader == "port" else "port"
    urls = [f"pipe:cat {p}" if pipe else str(p) for p in shards[writer]]
    back = {p: list(CUTSETS[p].from_webdataset(urls, shuffle_shards=True)) for p in WDS}
    assert [c.id for c in back["port"]] == [c.id for c in back["jax"]]
    source = {c.id: c for c in _cuts("jax", manifest)}
    for ours, theirs in zip(back[reader], back[writer]):
        assert ours.to_dict() == theirs.to_dict()
        assert ours.shard_origin == theirs.shard_origin
        assert np.array_equal(ours.load_audio(), source[ours.id].load_audio())
        assert np.array_equal(ours.load_features(), theirs.load_features())


def test_mini_webdataset_and_shufflers_equal(manifest, tmp_path):
    shards = [str(p) for p in _export_both(manifest, tmp_path, "wav", shard_size=1)["jax"]]
    for epoch in range(3):
        samples = [list(wds.mini_webdataset(shards, epoch=epoch, shuffle_shards=True))
                   for wds in WDS.values()]
        assert samples[0] == samples[1]
        assert [pickle.loads(s["data"])["id"] for s in samples[1]] and all(
            s["__key__"] == pickle.loads(s["data"])["id"] for s in samples[1])
    jshuf, pshuf = jwds.create_shard_shuffler(2), pwds.create_shard_shuffler(2)
    for _ in range(3):
        assert pshuf(shards) == jshuf(shards)


def test_shard_writer_equal(tmp_path):
    """``ShardWriter`` is the class (the module's earlier ``TarWriter``
    alias is shadowed in the JAX package): the same samples give the same
    shard bytes, rolled over after ``maxcount`` samples."""
    assert isinstance(pwds.ShardWriter, type) and pwds.ShardWriter.__name__ == "ShardWriter"
    samples = [{"__key__": f"k{i}", "txt": f"text {i}", "bin": bytes(range(i + 1))}
               for i in range(5)]
    for name, wds in WDS.items():
        (tmp_path / name).mkdir()
        with wds.ShardWriter(str(tmp_path / name / "w-%03d.tar"), maxcount=2) as w:
            for s in samples:
                w.write(s)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == [
        "w-000.tar", "w-001.tar", "w-002.tar"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def test_writer_output_paths_and_exports():
    import lhotse_tpu_torch.dataset as pdataset

    for name in ("LazyWebdatasetIterator", "WebdatasetWriter", "export_to_webdataset"):
        assert getattr(pdataset, name) is getattr(pwds, name)
    w = pwds.WebdatasetWriter("x-%03d.tar", shard_size=2)
    with pytest.raises(ValueError, match="not written"):
        w.output_manifest_paths()
