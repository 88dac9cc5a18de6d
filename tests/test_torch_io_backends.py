"""
The port's I/O backends (``lhotse_tpu_torch/serialization.py``), ``url``
audio sources, manifests and ``.idx`` files behind them, and the AIS batch
loader (``lhotse_tpu_torch/ais``) against the JAX package's, on the same
files: tar members read byte for byte as JAX reads them, the same backend
chain and dispatch, the same errors where a member, an archive or a
package is missing, the same audio (``np.array_equal``) and the same
injected batches. ``smart_open``, ``aistore`` and ``multistorageclient``
import on neither machine: each is given to both packages as one stub
module that serves a local directory, and the tests without it hold the
port to JAX's error.
"""
import importlib.machinery
import io
import sys
import tarfile
import types

import numpy as np
import pytest

import lhotse_tpu as J
import lhotse_tpu_torch as P
import lhotse_tpu.ais as jais
import lhotse_tpu.indexing as jidx
import lhotse_tpu.serialization as jser
import lhotse_tpu.utils.core as jutils
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.testing import dummies as JD
from lhotse_tpu_torch import ais as pais
from lhotse_tpu_torch import indexing as pidx
from lhotse_tpu_torch import serialization as pser
from lhotse_tpu_torch import utils as putils
from lhotse_tpu_torch.audio import AudioSource, Recording
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
from lhotse_tpu_torch.testing import dummies as PD

SR = 16000
N_UTT = 6


def _burst(rng, seconds: float) -> np.ndarray:
    n = int(SR * seconds)
    t = np.arange(n) / SR
    wave = np.sin(2 * np.pi * rng.uniform(100, 300) * t) * 0.3 + rng.standard_normal(n) * 0.01
    return wave.astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six FLAC bursts of 0.4-1.2 s, in a directory and packed into a
    ``.tar`` and a ``.tar.gz`` shard; a manifest of their cuts, plain and
    gzipped, with its ``.idx``, in a third tar."""
    root = tmp_path_factory.mktemp("io_corpus")
    rng = np.random.default_rng(7)
    flacs = root / "flac"
    flacs.mkdir()
    for i in range(N_UTT):
        jwrite_flac(str(flacs / f"utt{i}.flac"), _burst(rng, float(rng.uniform(0.4, 1.2))), SR)
    for name, mode in (("shard.tar", "w"), ("shard.tar.gz", "w:gz")):
        with tarfile.open(root / name, mode) as tar:
            for i in range(N_UTT):
                tar.add(flacs / f"utt{i}.flac", arcname=f"utt{i}.flac")
    cuts = J.CutSet.from_cuts(
        J.Recording.from_file(flacs / f"utt{i}.flac").to_cut() for i in range(N_UTT))
    cuts.to_file(root / "cuts.jsonl")
    cuts.to_file(root / "cuts.jsonl.gz")
    jidx.create_jsonl_index(root / "cuts.jsonl")
    with tarfile.open(root / "manifests.tar", "w") as tar:
        for name in ("cuts.jsonl", "cuts.jsonl.gz", "cuts.jsonl.idx"):
            tar.add(root / name, arcname=name)
    return root


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares what each package raises
        return type(e).__name__, str(e)
    return None


# -- the chain, the dispatch and the current backend ---------------------------------------


def test_default_chain_and_available_backends_equal_jax():
    ours = [type(b).__name__ for b in pser.get_default_io_backend().backends]
    theirs = [type(b).__name__ for b in jser.get_default_io_backend().backends]
    assert ours == theirs == [
        "RedirectIOBackend", "PipeIOBackend", "TarAsDirBackend", "GzipIOBackend",
        "BuiltinIOBackend"]
    assert pser.available_io_backends() == jser.available_io_backends()
    assert set(pser.IOBackend.KNOWN_BACKENDS) == set(jser.IOBackend.KNOWN_BACKENDS)


@pytest.mark.parametrize("identifier", [
    "-", "pipe:cat x.tar/y", "/d/a.tar/m.flac", "/d/a.tar.gz/m.flac", "/d/a.tar.bz2/sub/m.flac",
    "/d/cuts.jsonl.gz", "/d/cuts.jsonl", "https://h.invalid/a.tar/m.flac",
    "https://h.invalid/c.jsonl.gz", "s3://b/k.flac", "ais://b/k.flac", "msc://p/k.flac"])
def test_special_case_dispatch_equals_jax(identifier):
    """The backend the composite picks: a special case first, in chain order,
    then the first applicable one; ``None`` where none applies."""
    def pick(module):
        chain = module.get_default_io_backend().backends
        special = [type(b).__name__ for b in chain if b.handles_special_case(identifier)]
        generic = [type(b).__name__ for b in chain if b.is_applicable(identifier)]
        return (special or generic or [None])[0]

    assert pick(pser) == pick(jser)
    for name in ("TarAsDirBackend", "SmartOpenIOBackend", "AIStoreIOBackend", "MSCIOBackend"):
        ours, theirs = pser.IOBackend.new(name), jser.IOBackend.new(name)
        assert ours.handles_special_case(identifier) == theirs.handles_special_case(identifier)
        assert ours.is_applicable(identifier) == theirs.is_applicable(identifier)


def test_set_current_io_backend_context_and_environment(monkeypatch, corpus):
    monkeypatch.delenv("LHOTSE_TPU_IO_BACKEND", raising=False)
    monkeypatch.delenv("LHOTSE_IO_BACKEND", raising=False)
    for module in (pser, jser):
        assert type(module.get_current_io_backend()).__name__ == "CompositeIOBackend"
        with module.io_backend("BuiltinIOBackend"):
            assert type(module.get_current_io_backend()).__name__ == "BuiltinIOBackend"
            with module.io_backend(module.PipeIOBackend()):
                assert type(module.get_current_io_backend()).__name__ == "PipeIOBackend"
            assert type(module.get_current_io_backend()).__name__ == "BuiltinIOBackend"
        assert module.CURRENT_IO_BACKEND is None
        monkeypatch.setenv("LHOTSE_IO_BACKEND", "GzipIOBackend")
        assert type(module.get_current_io_backend()).__name__ == "GzipIOBackend"
        monkeypatch.setenv("LHOTSE_TPU_IO_BACKEND", "TarAsDirBackend")
        assert type(module.get_current_io_backend()).__name__ == "TarAsDirBackend"
        with module.open_best(corpus / "shard.tar/utt0.flac", "rb") as f:
            assert f.read() == (corpus / "flac" / "utt0.flac").read_bytes()
        monkeypatch.delenv("LHOTSE_TPU_IO_BACKEND")
        monkeypatch.delenv("LHOTSE_IO_BACKEND")
        module.set_current_io_backend("BuiltinIOBackend")
        try:
            assert type(module.get_current_io_backend()).__name__ == "BuiltinIOBackend"
        finally:
            module.CURRENT_IO_BACKEND = None
    with pytest.raises(KeyError):
        pser.set_current_io_backend("NoSuchBackend")
    with pytest.raises(KeyError):
        jser.set_current_io_backend("NoSuchBackend")


# -- tar members ---------------------------------------------------------------------------


@pytest.mark.parametrize("archive", ["shard.tar", "shard.tar.gz"])
def test_tar_members_read_as_jax_reads_them(corpus, archive):
    for i in range(N_UTT):
        path = corpus / archive / f"utt{i}.flac"
        with pser.open_best(path, "rb") as f:
            ours = f.read()
        with jser.open_best(path, "rb") as f:
            theirs = f.read()
        assert ours == theirs == (corpus / "flac" / f"utt{i}.flac").read_bytes()
        assert pser.TarAsDirBackend().open(str(path), "rb").read() == ours


@pytest.mark.parametrize("archive", ["shard.tar", "shard.tar.gz"])
def test_missing_member_or_archive_raises_as_jax(corpus, archive):
    for path in (corpus / archive / "missing.flac", corpus / "nowhere" / archive / "utt0.flac"):
        ours = _raised(lambda: pser.open_best(path, "rb"))
        assert ours is not None and ours[0] == "FileNotFoundError"
        assert ours == _raised(lambda: jser.open_best(path, "rb"))


def test_a_file_that_is_not_a_tar_raises_as_jax(tmp_path):
    (tmp_path / "fake.tar").write_bytes(b"not a tar" * 100)
    path = tmp_path / "fake.tar" / "utt.flac"
    ours = _raised(lambda: pser.open_best(path, "rb"))
    assert ours is not None and ours[0] == "FileNotFoundError"
    assert ours == _raised(lambda: jser.open_best(path, "rb"))


# -- url audio sources ---------------------------------------------------------------------


def _url_recording(module, source: str, rid: str, num_samples: int):
    return module.Recording(
        id=rid, sources=[module.AudioSource(type="url", channels=[0], source=source)],
        sampling_rate=SR, num_samples=num_samples, duration=num_samples / SR)


@pytest.mark.parametrize("archive", ["shard.tar", "shard.tar.gz"])
def test_url_audio_through_a_tar_member_equals_jax(corpus, archive):
    for i in range(N_UTT):
        n = J.Recording.from_file(corpus / "flac" / f"utt{i}.flac").num_samples
        url = str(corpus / archive / f"utt{i}.flac")
        ours = _url_recording(P, url, f"utt{i}", n)
        theirs = _url_recording(J, url, f"utt{i}", n)
        assert ours.to_dict() == theirs.to_dict()
        audio = ours.load_audio()
        np.testing.assert_array_equal(audio, theirs.load_audio())
        np.testing.assert_array_equal(
            audio, Recording.from_file(corpus / "flac" / f"utt{i}.flac").load_audio())
        # A window reads the same samples in both packages.
        np.testing.assert_array_equal(ours.load_audio(offset=0.1, duration=0.2),
                                      theirs.load_audio(offset=0.1, duration=0.2))


def test_url_audio_through_a_pipe_and_the_cache_equals_jax(corpus):
    from lhotse_tpu.caching import AudioCache as JCache
    from lhotse_tpu_torch.caching import AudioCache, set_caching_enabled

    path = corpus / "flac" / "utt1.flac"
    n = J.Recording.from_file(path).num_samples
    url = f"pipe:cat {path}"
    ours = _url_recording(P, url, "utt1", n)
    theirs = _url_recording(J, url, "utt1", n)
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())
    set_caching_enabled(True)
    J.set_caching_enabled(True)
    try:
        np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())
        assert AudioCache.try_cache(url) == JCache.try_cache(url) == path.read_bytes()
    finally:
        set_caching_enabled(False)
        J.set_caching_enabled(False)


@pytest.mark.parametrize("source", [
    "cat x.wav", "https://example.invalid/a.flac", "/nowhere/shard.tar/utt0.flac"])
def test_url_audio_nothing_serves_raises_as_jax(source):
    ours = _raised(lambda: AudioSource(type="url", channels=[0], source=source).load_audio())
    theirs = _raised(lambda: J.AudioSource(type="url", channels=[0], source=source).load_audio())
    assert ours is not None and ours == theirs


# -- manifests and index files inside a tar --------------------------------------------------


def test_manifest_inside_a_tar_equals_jax(corpus):
    path = corpus / "manifests.tar" / "cuts.jsonl"
    ours, theirs = CutSet.from_file(path), J.CutSet.from_file(path)
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    assert len(ours) == N_UTT
    assert [c.id for c in CutSet.from_jsonl_lazy(path)] == [c.id for c in ours]
    assert [c.to_dict() for c in ours] == [
        c.to_dict() for c in CutSet.from_file(corpus / "cuts.jsonl")]


def test_gzipped_manifest_inside_a_tar_reads_where_jax_raises(corpus):
    """A member whose name ends in ``.gz``: JAX's ``TarAsDirBackend`` hands
    back its compressed bytes, so the JAX package cannot read a gzipped
    manifest from a tar (ROADMAP.md C2); the port decompresses it."""
    path = corpus / "manifests.tar" / "cuts.jsonl.gz"
    with pytest.raises(UnicodeDecodeError):
        J.CutSet.from_file(path)
    with jser.open_best(path, "rb") as f:
        assert f.read() == (corpus / "cuts.jsonl.gz").read_bytes()
    ours = CutSet.from_file(path)
    assert [c.to_dict() for c in ours] == [
        c.to_dict() for c in J.CutSet.from_file(corpus / "cuts.jsonl.gz")]
    assert [c.id for c in CutSet.from_jsonl_lazy(path)] == [c.id for c in ours]
    with pser.open_best(path, "rb") as f:
        assert f.read() == (corpus / "cuts.jsonl").read_bytes()


def test_index_inside_a_tar_as_jax(corpus, tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    member = corpus / "manifests.tar" / "cuts.jsonl.idx"
    # A tar member is no local file for the index readers, in either package.
    ours = _raised(lambda: pidx.read_index(member))
    assert ours is not None and ours == _raised(lambda: jidx.read_index(member))
    ours = _raised(lambda: pidx.index_exists(corpus / "x.jsonl", index_path=member))
    assert ours == ("NotADirectoryError", f"[Errno 20] Not a directory: '{member}'")
    assert ours == _raised(lambda: jidx.index_exists(corpus / "x.jsonl", index_path=member))
    # Through a pipe it is read and cached, as JAX does.
    piped = f"pipe:tar -xOf {corpus / 'manifests.tar'} cuts.jsonl.idx"
    expected = np.fromfile(corpus / "cuts.jsonl.idx", dtype=np.uint64)
    np.testing.assert_array_equal(pidx.read_index(piped), expected)
    np.testing.assert_array_equal(jidx.read_index(piped), expected)
    assert pidx.index_exists(corpus / "cuts.jsonl", index_path=piped)


def test_index_behind_an_unserved_url_raises_as_jax(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    url = "https://example.invalid/cuts.jsonl.idx"
    ours = _raised(lambda: pidx.read_index(url))
    assert ours == ("RuntimeError", f"Couldn't find any applicable IOBackend for: {url}")
    assert ours == _raised(lambda: jidx.read_index(url))
    assert not pidx.index_exists("https://example.invalid/cuts.jsonl")
    assert not jidx.index_exists("https://example.invalid/cuts.jsonl")


# -- the gated backends, with and without their packages -------------------------------------


def _clear_module_caches():
    putils._module_available.cache_clear()
    jutils._module_available.cache_clear()
    pser.get_aistore_client.cache_clear()
    jser.get_aistore_client.cache_clear()


@pytest.fixture
def stub_module(monkeypatch):
    """``stub_module(name, **attrs)``: a module in ``sys.modules`` that
    ``importlib.util.find_spec`` finds, for both packages, until the test
    ends."""
    _clear_module_caches()

    def make(name, **attrs):
        module = types.ModuleType(name)
        module.__spec__ = importlib.machinery.ModuleSpec(name, None)
        module.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, name, module)
        _clear_module_caches()
        return module

    yield make
    monkeypatch.undo()
    _clear_module_caches()


def test_gated_backends_without_their_packages_raise_as_jax(monkeypatch):
    _clear_module_caches()
    monkeypatch.delenv("AIS_ENDPOINT", raising=False)
    for name in ("SmartOpenIOBackend", "AIStoreIOBackend", "MSCIOBackend"):
        assert pser.IOBackend.KNOWN_BACKENDS[name].is_available() is False
        assert jser.IOBackend.KNOWN_BACKENDS[name].is_available() is False
        ours = _raised(lambda: pser.IOBackend.new(name).open("s3://b/k.flac", "rb"))
        assert ours is not None and ours == _raised(
            lambda: jser.IOBackend.new(name).open("s3://b/k.flac", "rb"))
    for fn in ("setup", "open"):
        ours = _raised(lambda: getattr(putils.SmartOpen, fn)("s3://b/k"))
        assert ours[0] == "ImportError" and ours == _raised(
            lambda: getattr(jutils.SmartOpen, fn)("s3://b/k"))
    assert _raised(pser.get_aistore_client) == _raised(jser.get_aistore_client)
    assert pser.is_aistore_available() is jser.is_aistore_available() is False
    ours = _raised(lambda: pais.batch_loader.AISBatchFetcher())
    assert ours[0] == "AssertionError" and ours == _raised(
        lambda: jais.batch_loader.AISBatchFetcher())
    assert _raised(lambda: pais.AISRangeReader("ais://b/k")) == _raised(
        lambda: jais.AISRangeReader("ais://b/k"))


def _local_opener(root, calls):
    """A ``smart_open``/``multistorageclient`` ``open`` that serves
    ``<scheme>://<bucket>/<key>`` from ``root/<bucket>/<key>``."""
    def open_(uri, mode="rb", **kwargs):
        calls.append((uri, mode, kwargs))
        bucket_key = uri.split("://", 1)[1]
        return open(root / bucket_key, mode)

    return open_


def test_smart_open_stub_serves_urls_in_both_packages(stub_module, corpus, tmp_path, monkeypatch):
    import shutil
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    bucket = tmp_path / "bucket"
    shutil.copytree(corpus / "flac", bucket)
    for name in ("cuts.jsonl", "cuts.jsonl.idx"):
        shutil.copy(corpus / name, bucket / name)
    calls = []
    stub_module("smart_open", open=_local_opener(tmp_path, calls))
    assert pser.SmartOpenIOBackend.is_available() and jser.SmartOpenIOBackend.is_available()
    ours = [type(b).__name__ for b in pser.get_default_io_backend().backends]
    assert ours == [type(b).__name__ for b in jser.get_default_io_backend().backends]
    assert "SmartOpenIOBackend" in ours
    assert pser.available_io_backends() == jser.available_io_backends()
    # Audio, a manifest and an index behind the URL, in both packages.
    n = J.Recording.from_file(corpus / "flac" / "utt2.flac").num_samples
    url = "s3://bucket/utt2.flac"
    np.testing.assert_array_equal(
        _url_recording(P, url, "u", n).load_audio(),
        _url_recording(J, url, "u", n).load_audio())
    assert [c.to_dict() for c in CutSet.from_file("s3://bucket/cuts.jsonl")] == [
        c.to_dict() for c in J.CutSet.from_file("s3://bucket/cuts.jsonl")]
    np.testing.assert_array_equal(pidx.read_index("s3://bucket/cuts.jsonl.idx"),
                                  jidx.read_index("s3://bucket/cuts.jsonl.idx"))
    # The default sidecar of a URL is a local path, in both packages.
    assert pidx.index_exists("s3://bucket/cuts.jsonl") is jidx.index_exists(
        "s3://bucket/cuts.jsonl") is False
    assert pidx.index_exists("s3://bucket/cuts.jsonl", index_path="s3://bucket/cuts.jsonl.idx")
    # Transport parameters set up once go with every open, in both packages.
    for utils in (putils, jutils):
        calls.clear()
        utils.SmartOpen.setup({"client": "c"})
        try:
            utils.SmartOpen.open("s3://bucket/utt0.flac").close()
            assert calls == [("s3://bucket/utt0.flac", "rb", {"transport_params": {"client": "c"}})]
        finally:
            utils.SmartOpen.transport_params = None


class _AisObject:
    def __init__(self, path):
        self.path = path

    def head(self):
        return {"Content-Length": str(self.path.stat().st_size)}

    def get_reader(self, byte_range=None):
        data = self.path.read_bytes()
        if byte_range is not None:
            lo, hi = byte_range[len("bytes="):].split("-")
            data = data[int(lo): None if hi == "" else int(hi) + 1]
        return types.SimpleNamespace(read_all=lambda: data, as_file=lambda: io.BytesIO(data))


def _aistore_stub(root):
    class Client:
        endpoints = []

        def __init__(self, endpoint):
            Client.endpoints.append(endpoint)

        def fetch_object_by_url(self, url):
            return _AisObject(root / url.split("://", 1)[1])

    return Client


def test_aistore_stub_serves_reads_in_both_packages(stub_module, corpus, tmp_path, monkeypatch):
    import gzip
    import shutil

    shutil.copytree(corpus / "flac", tmp_path / "bucket")
    (tmp_path / "bucket" / "cuts.jsonl.gz").write_bytes(
        (corpus / "cuts.jsonl.gz").read_bytes() + b"trailing garbage")
    client = _aistore_stub(tmp_path)
    stub_module("aistore", Client=client)
    monkeypatch.delenv("AIS_ENDPOINT", raising=False)
    assert not pser.AIStoreIOBackend.is_available() and not jser.AIStoreIOBackend.is_available()
    assert _raised(pser.get_aistore_client) == _raised(jser.get_aistore_client)
    monkeypatch.setenv("AIS_ENDPOINT", "http://localhost:51080")
    _clear_module_caches()
    assert pser.AIStoreIOBackend.is_available() and jser.AIStoreIOBackend.is_available()
    assert "AIStoreIOBackend" in [type(b).__name__ for b in pser.get_default_io_backend().backends]
    url = "ais://bucket/utt3.flac"
    with pser.open_best(url, "rb") as f, jser.open_best(url, "rb") as g:
        assert f.read() == g.read() == (corpus / "flac" / "utt3.flac").read_bytes()
    # A gzipped object reads through the robust gzip reader, trailing garbage and all.
    with pser.open_best("ais://bucket/cuts.jsonl.gz", "rb") as f:
        ours = f.read()
    with jser.open_best("ais://bucket/cuts.jsonl.gz", "rb") as f:
        assert ours == f.read() == gzip.decompress((corpus / "cuts.jsonl.gz").read_bytes())
    assert _raised(lambda: pser.AIStoreIOBackend().open(url, "x")) == _raised(
        lambda: jser.AIStoreIOBackend().open(url, "x"))
    # The range reader and the AIS fetcher read the same bytes as the local fetcher.
    for module in (pais, jais):
        reader = module.AISRangeReader(url)
        assert reader.size == (corpus / "flac" / "utt3.flac").stat().st_size
        reader.seek(10)
        assert reader.read(6) == (corpus / "flac" / "utt3.flac").read_bytes()[10:16]
        assert reader.tell() == 16
        requests = [module.FetchRequest(url=url), module.FetchRequest(url=url, start=4, end=12),
                    module.FetchRequest(url=url, start=20)]
        fetcher = module.batch_loader.AISBatchFetcher(force_individual=True)
        local = [module.FetchRequest(url=str(corpus / "flac" / "utt3.flac"), start=r.start,
                                     end=r.end) for r in requests]
        assert fetcher.fetch(requests) == module.LocalBatchFetcher().fetch(local)
        # With the SDK importable, the loader's lazy choice is the AIS fetcher.
        assert type(module.AISBatchLoader().fetcher).__name__ == "AISBatchFetcher"
    assert set(client.endpoints) == {"http://localhost:51080"}


def test_msc_stub_with_overrides_in_both_packages(stub_module, corpus, tmp_path, monkeypatch):
    import shutil

    shutil.copytree(corpus / "flac", tmp_path / "prof")
    calls = []
    stub_module("multistorageclient", open=_local_opener(tmp_path, calls))
    for key in ("LHOTSE_MSC_OVERRIDE_PROTOCOLS", "LHOTSE_MSC_PROFILE", "LHOTSE_MSC_BACKEND_FORCED"):
        monkeypatch.delenv(key, raising=False)
    assert pser.MSCIOBackend.is_available() and jser.MSCIOBackend.is_available()
    seen = {}
    for name, module in (("port", pser), ("jax", jser)):
        calls.clear()
        with module.open_best("msc://prof/utt4.flac", "rb") as f:
            data = f.read()
        monkeypatch.setenv("LHOTSE_MSC_OVERRIDE_PROTOCOLS", "s3")
        monkeypatch.setenv("LHOTSE_MSC_PROFILE", "prof")
        monkeypatch.setenv("LHOTSE_MSC_BACKEND_FORCED", "true")
        with module.MSCIOBackend().open("s3://other/utt4.flac", "rb") as f:
            assert f.read() == data
        applicable = module.MSCIOBackend().is_applicable("https://h.invalid/x")
        for key in ("LHOTSE_MSC_OVERRIDE_PROTOCOLS", "LHOTSE_MSC_PROFILE",
                    "LHOTSE_MSC_BACKEND_FORCED"):
            monkeypatch.delenv(key)
        seen[name] = (data, [c[:2] for c in calls], applicable,
                      module.MSCIOBackend().is_applicable("https://h.invalid/x"))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == (corpus / "flac" / "utt4.flac").read_bytes()
    assert seen["port"][1] == [("msc://prof/utt4.flac", "rb"), ("msc://prof/utt4.flac", "rb")]
    assert seen["port"][2:] == (True, False)


# -- the AIS batch loader, case by case against tests/test_ais_batch_loader.py ---------------


@pytest.fixture(scope="module")
def shar_cuts(tmp_path_factory):
    """Four dummy cuts with data, exported by the JAX package to an indexed
    Shar (two shards) and read back lazily (``shar_ptr``) by each package;
    each package's eager cuts come from its own dummies under one numpy
    seed."""
    out = tmp_path_factory.mktemp("ais") / "shar"
    made = {}
    for name, dummies, cutset in (("jax", JD, J.CutSet), ("port", PD, CutSet)):
        np.random.seed(0)
        base = []
        for i in range(4):
            c = dummies.dummy_cut(i, with_data=True, duration=1.0)
            c.custom = {"custom_features": c.custom["custom_features"]}
            base.append(c)
        made[name] = cutset.from_cuts(base)
    made["jax"].to_shar(
        out, fields={"recording": "wav", "features": "lilcom", "custom_features": "lilcom"},
        shard_size=2, compress_jsonl=False, create_index=True)
    lazy = {"jax": list(J.CutSet.from_shar(in_dir=out, indexed=True, lazy=True)),
            "port": list(CutSet.from_shar(in_dir=out, indexed=True, lazy=True))}
    return made, lazy


def _requests(triples):
    return [(type(owner[0]).__name__, owner[0].id, owner[1], slot,
             (req.url, req.start, req.end)) for owner, slot, req in triples]


def test_collect_requests_equal_jax(shar_cuts):
    _, lazy = shar_cuts
    ours = pais.collect_batch_requests(lazy["port"])
    assert len(ours) == 12 and all(isinstance(t[2], pais.FetchRequest) for t in ours)
    assert all(t[2].end is not None for t in ours)
    assert _requests(ours) == _requests(jais.collect_batch_requests(lazy["jax"]))


def test_batch_loader_injects_what_jax_injects(shar_cuts):
    made, lazy = shar_cuts
    ours = pais.AISBatchLoader(fetcher=pais.LocalBatchFetcher())(lazy["port"])
    theirs = jais.AISBatchLoader(fetcher=jais.LocalBatchFetcher())(lazy["jax"])
    assert isinstance(ours, CutSet) and len(ours) == len(lazy["port"])
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    for orig, loaded, jloaded in zip(made["port"], ours, theirs):
        assert loaded.recording.sources[0].type == "memory"
        assert loaded.features.storage_type == "memory_lilcom"
        assert loaded.custom["custom_features"].array.storage_type == "memory_lilcom"
        np.testing.assert_array_equal(loaded.load_audio(), jloaded.load_audio())
        np.testing.assert_array_equal(orig.load_audio(), loaded.load_audio())
        np.testing.assert_array_equal(loaded.load_features(), jloaded.load_features())
        np.testing.assert_allclose(orig.load_features(), loaded.load_features(), atol=2**-6)
        np.testing.assert_array_equal(loaded.load_custom_features(),
                                      jloaded.load_custom_features())


def test_batch_loader_noop_on_local_cuts():
    np.random.seed(1)
    ours = [PD.dummy_cut(i, with_data=True) for i in range(2)]
    np.random.seed(1)
    theirs = [JD.dummy_cut(i, with_data=True) for i in range(2)]
    out = pais.AISBatchLoader(fetcher=pais.LocalBatchFetcher())(ours)
    jout = jais.AISBatchLoader(fetcher=jais.LocalBatchFetcher())(theirs)
    assert len(out) == len(jout) == 2
    assert [c.to_dict() for c in out] == [c.to_dict() for c in jout] == [
        c.to_dict() for c in ours]
    assert pais.collect_batch_requests(ours) == jais.collect_batch_requests(theirs) == []


def _counting(base):
    class CountingFetcher(base):
        def __init__(self):
            self.calls = []

        def fetch(self, requests):
            self.calls.append([(r.url, r.start, r.end) for r in requests])
            return super().fetch(requests)

    return CountingFetcher()


def test_batch_loader_dedups_identical_ranges_as_jax(shar_cuts):
    _, lazy = shar_cuts
    ours, theirs = _counting(pais.LocalBatchFetcher), _counting(jais.LocalBatchFetcher)
    out = pais.AISBatchLoader(fetcher=ours)([lazy["port"][0], lazy["port"][0]])
    jout = jais.AISBatchLoader(fetcher=theirs)([lazy["jax"][0], lazy["jax"][0]])
    assert [len(c) for c in ours.calls] == [3]  # recording + features + array, once
    assert ours.calls == theirs.calls
    assert [c.to_dict() for c in out] == [c.to_dict() for c in jout]


def test_batch_loader_error_on_bad_fetch_as_jax(shar_cuts):
    _, lazy = shar_cuts

    class BrokenFetcher:
        def fetch(self, requests):
            raise IOError("boom")

    ours = _raised(lambda: pais.AISBatchLoader(fetcher=BrokenFetcher())(lazy["port"]))
    assert ours == ("AISBatchLoaderError", "Batch fetch of 12 objects failed: boom")
    assert ours == _raised(lambda: jais.AISBatchLoader(fetcher=BrokenFetcher())(lazy["jax"]))

    class ShortFetcher:
        def fetch(self, requests):
            return [b""]

    assert _raised(lambda: pais.AISBatchLoader(fetcher=ShortFetcher())(lazy["port"])) == _raised(
        lambda: jais.AISBatchLoader(fetcher=ShortFetcher())(lazy["jax"]))


def test_skip_failed_fetches_drops_what_jax_drops(shar_cuts):
    _, lazy = shar_cuts

    def flaky(base, bad):
        class FlakyFetcher(base):
            def fetch(self, requests):
                if any(r.url in bad for r in requests):
                    raise IOError("flaky object store")
                return super().fetch(requests)

        return FlakyFetcher()

    bad = {t[2].url for t in pais.collect_batch_requests([lazy["port"][0]])}
    assert bad == {t[2].url for t in jais.collect_batch_requests([lazy["jax"][0]])}
    out = pais.AISBatchLoader(fetcher=flaky(pais.LocalBatchFetcher, bad),
                              skip_failed_fetches=True)(lazy["port"])
    jout = jais.AISBatchLoader(fetcher=flaky(jais.LocalBatchFetcher, bad),
                               skip_failed_fetches=True)(lazy["jax"])
    survived = [c.id for c in out]
    assert survived == [c.id for c in jout]
    assert lazy["port"][0].id not in survived
    assert {lazy["port"][2].id, lazy["port"][3].id} <= set(survived)
    for c, jc in zip(out, jout):
        np.testing.assert_array_equal(c.load_audio(), jc.load_audio())
    assert _raised(lambda: pais.AISBatchLoader(fetcher=flaky(pais.LocalBatchFetcher, bad))(
        lazy["port"])) == _raised(lambda: jais.AISBatchLoader(
            fetcher=flaky(jais.LocalBatchFetcher, bad))(lazy["jax"]))


def test_audio_samples_with_batch_loader_equal_jax(shar_cuts):
    from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples

    made, lazy = shar_cuts
    strategy = AudioSamples(use_batch_loader=True, ais_force_individual=True)
    jstrategy = JAudioSamples(use_batch_loader=True, ais_force_individual=True)
    loader = strategy.ais_batch_loader
    assert loader.force_individual and not loader.skip_failed_fetches
    assert AudioSamples(use_batch_loader=True, fault_tolerant=True).ais_batch_loader \
        .skip_failed_fetches
    assert AudioSamples().ais_batch_loader is None
    # No aistore on this machine: the lazy choice is the local fetcher, in both packages.
    assert type(loader.fetcher).__name__ == type(jstrategy.ais_batch_loader.fetcher).__name__ == \
        "LocalBatchFetcher"
    with pytest.raises(AttributeError, match="no AIStore client"):
        loader.client
    strategy.ais_batch_loader.fetcher = pais.LocalBatchFetcher()
    audio, audio_lens = strategy(CutSet.from_cuts(lazy["port"]))
    jaudio, jaudio_lens = jstrategy(J.CutSet.from_cuts(lazy["jax"]))
    np.testing.assert_array_equal(np.asarray(audio), np.asarray(jaudio))
    np.testing.assert_array_equal(np.asarray(audio_lens), np.asarray(jaudio_lens))
    np.testing.assert_array_equal(np.asarray(audio)[0, : int(audio_lens[0])],
                                  made["port"][0].load_audio()[0])
    plain, plain_lens = AudioSamples()(CutSet.from_cuts(lazy["port"]))
    np.testing.assert_array_equal(np.asarray(audio), np.asarray(plain))
    np.testing.assert_array_equal(np.asarray(audio_lens), np.asarray(plain_lens))


def test_local_fetcher_ranges_equal_jax(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(bytes(range(100)))
    got = {}
    for name, module in (("port", pais), ("jax", jais)):
        got[name] = module.LocalBatchFetcher().fetch([
            module.FetchRequest(url=str(p)),
            module.FetchRequest(url=str(p), start=10, end=20),
            module.FetchRequest(url=f"file://{p}", start=90, end=None)])
    assert got["port"] == got["jax"] == [bytes(range(100)), bytes(range(10, 20)),
                                         bytes(range(90, 100))]
    assert pais.batch_loader.get_archive_extension("a/b.tar.gz/x") == \
        jais.batch_loader.get_archive_extension("a/b.tar.gz/x") == ".tar.gz"


def test_url_sources_and_file_features_are_requested_as_jax(corpus):
    """A ``url`` source is fetched whole, and only features behind a URL
    are requested; the local fetcher serves ``file://`` URLs."""
    path = corpus / "flac" / "utt5.flac"
    n = J.Recording.from_file(path).num_samples
    got = {}
    for name, module, ais in (("port", P, pais), ("jax", J, jais)):
        rec = _url_recording(module, f"file://{path}", "u5", n)
        cut = rec.to_cut()
        cut.features = module.Features(
            type="fbank", num_frames=10, num_features=4, frame_shift=0.01, sampling_rate=SR,
            start=0, duration=0.1, storage_type="numpy_files", storage_path="file:///d",
            storage_key="k.npy")
        triples = ais.collect_batch_requests([cut])
        loaded = ais.AISBatchLoader(fetcher=ais.LocalBatchFetcher())([cut.drop_features()])
        got[name] = (_requests(triples), loaded[0].recording.sources[0].source,
                     loaded[0].load_audio())
    assert got["port"][:2] == got["jax"][:2]
    assert got["port"][0] == [
        ("MonoCut", got["port"][0][0][1], "recording", "source:0", (f"file://{path}", 0, None)),
        ("MonoCut", got["port"][0][0][1], "features", "storage", ("file:///d/k.npy", 0, None))]
    assert got["port"][1] == path.read_bytes()
    np.testing.assert_array_equal(got["port"][2], got["jax"][2])


# -- shar_ptr payloads through AudioCache (ROADMAP C4) ------------------------------------------


@pytest.mark.parametrize("caching", [True, False])
def test_shar_ptr_payload_reads_go_through_the_cache_as_jax(shar_cuts, monkeypatch, caching):
    """Three ``load_audio()`` calls of one ``shar_ptr`` source read its
    payload once with caching on and three times with it off, in both
    packages, and give the same samples."""
    import lhotse_tpu.shar.lazy_pointer as jptr
    import lhotse_tpu_torch.shar.lazy_pointer as pptr
    from lhotse_tpu.caching import AudioCache as JCache
    from lhotse_tpu.caching import set_caching_enabled as jset
    from lhotse_tpu_torch.caching import AudioCache as PCache
    from lhotse_tpu_torch.caching import set_caching_enabled as pset

    _, lazy = shar_cuts
    audio, reads = {}, {}
    for name, module, cache, toggle, cut in (("jax", jptr, JCache, jset, lazy["jax"][1]),
                                             ("port", pptr, PCache, pset, lazy["port"][1])):
        assert cut.recording.sources[0].type == "shar_ptr"
        calls = []
        read = module.read_payload
        monkeypatch.setattr(module, "read_payload",
                            lambda source, _read=read, _calls=calls: (_calls.append(1),
                                                                      _read(source))[1])
        toggle(caching)
        cache.clear()
        try:
            audio[name] = [cut.load_audio() for _ in range(3)]
        finally:
            toggle(False)
            cache.clear()
        reads[name] = len(calls)
    assert reads["port"] == reads["jax"] == (1 if caching else 3)
    for ours, theirs in zip(audio["port"], audio["jax"]):
        assert np.array_equal(ours, theirs)
