"""
``CutSet.from_files`` of the port (``lhotse_tpu_torch/cut/set.py``) against
the JAX package's on the same shards: the order with and without ``.idx``
sidecars (item-level Feistel shuffling when every file is indexed, file
order shuffling otherwise), with ``index_path``, across epochs and after a
resume. And the ``-`` and ``pipe:`` I/O of ``open_best``
(``lhotse_tpu_torch/serialization.py``), with ``.idx`` files read through
a pipe (``lhotse_tpu_torch/indexing.py``).
"""
import copy
import io
import shutil
import sys

import pytest

import lhotse_tpu as J
from lhotse_tpu import indexing as jidx
from lhotse_tpu import serialization as jser
from lhotse_tpu.testing.dummies import DummyManifest as JDummyManifest
from lhotse_tpu_torch import indexing as pidx
from lhotse_tpu_torch import serialization as pser
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.lazy import LazyIndexedManifestIterator

N_SHARDS, PER_SHARD = 4, 7


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Four uncompressed JSONL shards of 7 cuts (written by the JAX package),
    their gzipped copies, and the sidecars of the plain ones in ``idx/``."""
    root = tmp_path_factory.mktemp("from_files")
    paths = []
    for s in range(N_SHARDS):
        p = root / f"cuts-{s}.jsonl"
        JDummyManifest(J.CutSet, begin_id=s * PER_SHARD, end_id=(s + 1) * PER_SHARD).to_file(p)
        JDummyManifest(J.CutSet, begin_id=s * PER_SHARD, end_id=(s + 1) * PER_SHARD).to_file(
            root / f"cuts-{s}.jsonl.gz")
        jidx.create_jsonl_index(p, output_path=root / "idx" / f"cuts-{s}.jsonl.idx")
        paths.append(p)
    return root, paths


def _ids(cuts):
    return [c.id for c in cuts]


def _both(make):
    return _ids(make(J.CutSet)), _ids(make(CutSet))


@pytest.mark.parametrize("sidecars", ["none", "beside", "index_path"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_order_equals_jax(shards, tmp_path, sidecars, shuffle):
    root, paths = shards
    kw = {}
    if sidecars == "beside":
        for p in paths:
            shutil.copy(root / "idx" / f"{p.name}.idx", tmp_path / f"{p.name}.idx")
            shutil.copy(p, tmp_path / p.name)
        paths = [tmp_path / p.name for p in paths]
    elif sidecars == "index_path":
        kw["index_path"] = [root / "idx" / f"{p.name}.idx" for p in paths]
    theirs, ours = _both(lambda cs: cs.from_files(paths, shuffle_iters=shuffle, seed=3, **kw))
    assert ours == theirs
    assert sorted(ours) == sorted(_ids(J.CutSet.from_file(p)) for p in paths) or \
        sorted(ours) == sorted(c for p in paths for c in _ids(J.CutSet.from_file(p)))
    indexed = sidecars != "none"
    cuts = CutSet.from_files(paths, shuffle_iters=shuffle, seed=3, **kw)
    assert all(isinstance(leaf, LazyIndexedManifestIterator) for leaf in cuts.data.sources) \
        == indexed
    if shuffle and indexed:
        # Item-level shuffling: the shards' cuts interleave.
        assert ours[:PER_SHARD] != _ids(CutSet.from_file(paths[0]))


def test_gzipped_files_are_not_indexed(shards):
    root, _ = shards
    paths = [root / f"cuts-{s}.jsonl.gz" for s in range(N_SHARDS)]
    theirs, ours = _both(lambda cs: cs.from_files(paths, seed=1))
    assert ours == theirs and len(ours) == N_SHARDS * PER_SHARD


def test_epochs_and_resume_equal_jax(shards):
    root, paths = shards
    index_path = [root / "idx" / f"{p.name}.idx" for p in paths]
    sets = {"jax": J.CutSet.from_files(paths, seed=0, index_path=index_path),
            "port": CutSet.from_files(paths, seed=0, index_path=index_path)}
    epochs = {k: [_ids(s), _ids(s)] for k, s in sets.items()}
    assert epochs["port"] == epochs["jax"] and epochs["port"][0] != epochs["port"][1]
    assert sorted(epochs["port"][0]) == sorted(epochs["port"][1])
    fresh = CutSet.from_files(paths, seed=0, index_path=index_path)
    it = iter(fresh)
    first = [next(it).id for _ in range(10)]
    state = copy.deepcopy(fresh.data.state_dict())
    resumed = CutSet.from_files(paths, seed=0, index_path=index_path)
    resumed.data.load_state_dict(state)
    assert first + _ids(resumed) == epochs["port"][0]


def test_index_path_length_mismatch(shards):
    _, paths = shards
    for cs in (J.CutSet, CutSet):
        with pytest.raises(ValueError, match="must match"):
            cs.from_files(paths, index_path=paths[:1])


# -- pipe: and - I/O ---------------------------------------------------------------------


def test_backends_listed_in_jax_order():
    assert {"PipeIOBackend", "RedirectIOBackend"} <= set(pser.available_io_backends())
    ours = [type(b).__name__ for b in pser.get_default_io_backend().backends]
    theirs = [type(b).__name__ for b in jser.get_default_io_backend().backends]
    assert ours == [n for n in theirs if n in ours] == [
        "RedirectIOBackend", "PipeIOBackend", "GzipIOBackend", "BuiltinIOBackend"]


@pytest.mark.parametrize("mode", ["r", "rb"])
def test_open_best_pipe_read(shards, mode):
    """Binary reads equal the JAX package's; a text read decodes UTF-8
    (the JAX package's pipe gives bytes in every mode)."""
    _, paths = shards
    with pser.open_best(f"pipe:cat {paths[0]}", mode) as f:
        ours = f.read()
    with jser.open_best(f"pipe:cat {paths[0]}", mode) as f:
        theirs = f.read()
    assert theirs == paths[0].read_bytes()
    assert ours == (theirs if mode == "rb" else theirs.decode("utf-8"))


def test_open_best_pipe_write_and_failure(tmp_path):
    for name, ser in (("port", pser), ("jax", jser)):
        with ser.open_best(f"pipe:gzip -c > {tmp_path / name}.gz", "wb") as f:
            f.write(b"hello pipe\n")
        import gzip

        assert gzip.decompress((tmp_path / f"{name}.gz").read_bytes()) == b"hello pipe\n"
        with pytest.raises(RuntimeError, match="exited with status"):
            with ser.open_best("pipe:exit 3", "rb") as f:
                f.read()


def test_manifest_through_a_pipe(shards, tmp_path):
    """JSONL manifests stream through pipes both ways in the port, lazily
    and in ``from_files``; the JAX package's pipe is not iterable, so its
    lazy read raises: a ``TypeError``, or the command's SIGPIPE status
    (141) when the pipe closes before the command ends."""
    _, paths = shards
    src = f"pipe:cat {paths[1]}"
    ours = [c.to_dict() for c in pser.load_manifest_lazy(src)]
    assert ours == [c.to_dict() for c in CutSet.from_file(paths[1])]
    with pytest.raises((TypeError, RuntimeError), match="not iterable|status 141"):
        list(jser.load_manifest_lazy(src))
    piped = [f"pipe:cat {p}" for p in paths]
    assert _ids(CutSet.from_files(piped, seed=2)) == _ids(J.CutSet.from_files(paths, seed=2))
    CutSet.from_file(paths[1]).to_file(f"pipe:cat > {tmp_path / 'out.jsonl'}")
    assert (tmp_path / "out.jsonl").read_bytes() == paths[1].read_bytes()


def test_open_best_dash(monkeypatch, capsys):
    """``-`` reads stdin and writes stdout, in text and in binary mode, and
    closing the wrapper leaves the stream open."""
    for ser in (pser, jser):
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(b"line one\n")))
        with ser.open_best("-", "r") as f:
            assert f.readline() == "line one\n"
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(b"line two\n")))
        with ser.open_best("-", "rb") as f:
            assert f.read() == b"line two\n"
        wrapper = ser.open_best("-", "w")
        wrapper.write("to stdout\n")
        wrapper.close()
        assert not sys.stdout.closed
    assert capsys.readouterr().out == "to stdout\n" * 2


def test_index_through_a_pipe(shards, tmp_path, monkeypatch):
    """An ``.idx`` behind a pipe is materialised into the temporary cache:
    ``read_index`` and ``index_exists`` through a pipe, and an indexed
    manifest whose sidecar is a pipe, equal to the JAX package's."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    root, paths = shards
    sidecar = root / "idx" / f"{paths[2].name}.idx"
    piped = f"pipe:cat {sidecar}"
    assert (pidx.read_index(piped) == jidx.read_index(piped)).all()
    assert (pidx.read_index(piped) == pidx.read_index(sidecar)).all()
    assert list((tmp_path / "lhotse-tpu-torch-index-cache").iterdir())
    assert pidx.index_exists(paths[2], index_path=piped)
    assert not pidx.index_exists(paths[2], index_path=f"pipe:cat {tmp_path / 'missing.idx'}")
    ours = LazyIndexedManifestIterator(paths[2], index_path=piped, shuffle=True, seed=2)
    from lhotse_tpu.lazy import LazyIndexedManifestIterator as JLazyIndexed

    theirs = JLazyIndexed(paths[2], index_path=piped, shuffle=True, seed=2)
    assert [c.id for c in ours] == [c.id for c in theirs]
    with pytest.raises(NotImplementedError, match="URLs"):
        pidx.read_index("https://example.org/cuts.jsonl.idx")
    # Written through a pipe, as the JAX package writes one.
    for name, idx in (("port", pidx), ("jax", jidx)):
        idx.create_jsonl_index(paths[2], output_path=f"pipe:cat > {tmp_path / name}.idx")
    assert (tmp_path / "port.idx").read_bytes() == (tmp_path / "jax.idx").read_bytes() == \
        sidecar.read_bytes()
