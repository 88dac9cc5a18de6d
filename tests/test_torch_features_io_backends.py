"""
The port's HDF5, Kaldi and ``lilcom_url`` feature stores
(``lhotse_tpu_torch/features/io.py``), ``workarounds.py``,
``CutSet.copy_feats`` and the ``copy-feats`` and ``feat upload`` commands
against the JAX package's: each store written by one package reads back in
the other, with every stored HDF5 dataset equal byte for byte (the LTC1
codec writes the JAX package's bytes, so the lilcom stores are exact too),
partial reads across the chunked store's 100-frame chunks, custom arrays,
the same store statuses, and copied manifests equal to JAX's as dicts once
the output directories are swapped. ``kaldi_native_io`` imports on neither
machine: one stub module given to both packages stands for it, and without
it both raise the same ``ValueError``.
"""
import gzip
import importlib.machinery
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

import lhotse_tpu as J
import lhotse_tpu.features.io as jio
import lhotse_tpu.utils.core as jutils
import lhotse_tpu.workarounds as jwork
import lhotse_tpu_torch as P
from lhotse_tpu.bin.modes import cli as jcli
from lhotse_tpu_torch import utils as putils
from lhotse_tpu_torch import workarounds as pwork
from lhotse_tpu_torch.bin.modes import cli as pcli
from lhotse_tpu_torch.features import io as pio

h5py = pytest.importorskip("h5py")

HDF5 = ("numpy_hdf5", "lilcom_hdf5", "chunked_lilcom_hdf5")
SHAPES = [(250, 80), (100, 80), (37, 13), (1, 80)]
WINDOWS = [(0, None), (0, 100), (37, 163), (99, 101), (100, 200), (150, None), (199, 250),
           (240, 250)]


def _feats(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).cumsum(axis=0) * 0.3 - 4.0).astype(np.float32)


def _write(io_module, name, path, mats, **kw):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with io_module.get_writer(name)(path, **kw) as writer:
        keys = [writer.write(f"utt-{i}", m) for i, m in enumerate(mats)]
        return keys, writer.storage_path


def _datasets(path) -> dict:
    """Every dataset of an HDF5 file by name: its dtype, shape and bytes."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                value = obj[()]
                out[name] = (str(obj.dtype), obj.shape, np.asarray(value).tobytes())

        f.visititems(visit)
    return out


# -- the HDF5 stores -----------------------------------------------------------------------


@pytest.mark.parametrize("name", HDF5)
def test_hdf5_store_written_by_either_package_reads_in_the_other(name, tmp_path):
    mats = [_feats(s, i) for i, s in enumerate(SHAPES)]
    keys, paths = {}, {}
    for label, io_module in (("port", pio), ("jax", jio)):
        keys[label], paths[label] = _write(io_module, name, tmp_path / label / "feats", mats)
        assert paths[label].endswith("feats.h5")
    assert keys["port"] == keys["jax"] == [f"utt-{i}" for i in range(len(mats))]
    assert _datasets(paths["port"]) == _datasets(paths["jax"])
    for writer_label, path in paths.items():
        ours = pio.get_reader(name)(path)
        theirs = jio.get_reader(name)(path)
        for key, mat in zip(keys[writer_label], mats):
            got = ours.read(key)
            np.testing.assert_array_equal(got, theirs.read(key))
            if name == "numpy_hdf5":
                np.testing.assert_array_equal(got, mat)
            else:
                assert np.abs(got - mat).max() <= 2.0 ** -6 + 1e-6
    pio.close_cached_file_handles()
    jio.close_cached_file_handles()


@pytest.mark.parametrize("name", HDF5)
def test_hdf5_partial_reads_equal_jax(name, tmp_path):
    """Windows within, across and at the edges of the chunked store's
    100-frame chunks."""
    mat = _feats((250, 40), 3)
    (key,), path = _write(jio, name, tmp_path / "feats.h5", [mat])
    ours, theirs = pio.get_reader(name)(path), jio.get_reader(name)(path)
    whole = ours.read(key)
    for left, right in WINDOWS:
        got = ours.read(key, left_offset_frames=left, right_offset_frames=right)
        np.testing.assert_array_equal(
            got, theirs.read(key, left_offset_frames=left, right_offset_frames=right))
        np.testing.assert_array_equal(got, whole[left:right])
    if name == "chunked_lilcom_hdf5":
        with h5py.File(path, "r") as f:
            assert int(f[pio.CHUNK_SIZE_KEY][()]) == pio.HDF5_CHUNK_SIZE == 100
            assert sorted(f[key]) == ["0", "1", "2"]
            assert pio.lookup_chunk_size(f) == jio.lookup_chunk_size(f) == 100
        assert ours.chunk_size == theirs.chunk_size == 100
    pio.close_cached_file_handles()


def test_chunked_reader_without_a_chunk_size_dataset_falls_back_as_jax(tmp_path):
    mat = _feats((230, 8), 4)
    (key,), path = _write(pio, "chunked_lilcom_hdf5", tmp_path / "feats", [mat])
    with h5py.File(path, "a") as f:
        del f[pio.CHUNK_SIZE_KEY]
    ours, theirs = pio.ChunkedLilcomHdf5Reader(path), jio.ChunkedLilcomHdf5Reader(path)
    assert ours.chunk_size == theirs.chunk_size == 100
    np.testing.assert_array_equal(ours.read(key, 120, 210), theirs.read(key, 120, 210))
    pio.close_cached_file_handles()


def test_hdf5_append_mode_and_handle_cache(tmp_path):
    mats = [_feats((20, 4), i) for i in range(3)]
    for io_module, label in ((pio, "port"), (jio, "jax")):
        path = tmp_path / f"{label}.h5"
        with io_module.NumpyHdf5Writer(path) as w:
            w.write("a", mats[0])
        with io_module.NumpyHdf5Writer(path, mode="a") as w:
            w.write("b", mats[1])
            w.flush()
        reader = io_module.NumpyHdf5Reader(path)
        assert io_module.lookup_cache_or_open(str(path)) is reader.hdf
        np.testing.assert_array_equal(reader.read("b", 5, 15), mats[1][5:15])
        io_module.close_cached_file_handles()
        assert io_module.lookup_cache_or_open.cache_info().currsize == 0
    assert _datasets(tmp_path / "port.h5") == _datasets(tmp_path / "jax.h5")


def test_numpy_hdf5_custom_arrays_equal_jax(tmp_path):
    emb = _feats((128,), 5)
    align = _feats((100, 3), 6)
    got = {}
    for label, module, io_module in (("port", P, pio), ("jax", J, jio)):
        (tmp_path / label).mkdir()
        with io_module.NumpyHdf5Writer(tmp_path / label / "arrays") as w:
            array = w.store_array("emb", emb)
            temporal = w.store_array("align", align, frame_shift=0.01, temporal_dim=0)
        cut = module.Recording(
            id="r", sources=[module.AudioSource(type="file", channels=[0], source="/x.wav")],
            sampling_rate=16000, num_samples=16000, duration=1.0).to_cut()
        cut.custom = {"emb": array, "align": temporal}
        got[label] = cut
    for writer_label in ("port", "jax"):
        ours = P.MonoCut.from_dict(got[writer_label].to_dict())
        theirs = J.MonoCut.from_dict(got[writer_label].to_dict())
        for cut in (ours, theirs):
            np.testing.assert_array_equal(cut.load_emb(), emb)
            np.testing.assert_array_equal(cut.load_align(), align)
            np.testing.assert_array_equal(cut.truncate(offset=0.2, duration=0.5).load_align(),
                                          align[20:70])
    port_dict = json.loads(json.dumps(got["port"].to_dict()).replace(str(tmp_path / "port"), "D"))
    jax_dict = json.loads(json.dumps(got["jax"].to_dict()).replace(str(tmp_path / "jax"), "D"))
    assert port_dict == jax_dict
    pio.close_cached_file_handles()
    jio.close_cached_file_handles()


def test_features_manifest_over_hdf5_loads_as_jax(tmp_path):
    mat = _feats((100, 80), 7)
    (key,), path = _write(jio, "lilcom_hdf5", tmp_path / "feats", [mat])
    line = {"type": "kaldi-fbank", "num_frames": 100, "num_features": 80, "frame_shift": 0.01,
            "sampling_rate": 16000, "start": 0.0, "duration": 1.0, "storage_type": "lilcom_hdf5",
            "storage_path": path, "storage_key": key, "channels": 0}
    ours, theirs = P.Features.from_dict(dict(line)), J.Features.from_dict(dict(line))
    np.testing.assert_array_equal(ours.load(), theirs.load())
    np.testing.assert_array_equal(ours.load(start=0.25, duration=0.5),
                                  theirs.load(start=0.25, duration=0.5))
    pio.close_cached_file_handles()


# -- statuses, gating and the Kaldi store ----------------------------------------------------


def _clear_module_caches():
    putils._module_available.cache_clear()
    jutils._module_available.cache_clear()
    pio.lookup_reader_cache_or_open.cache_clear()
    jio.lookup_reader_cache_or_open.cache_clear()


def test_storage_backend_statuses_equal_jax(monkeypatch):
    _clear_module_caches()
    assert pio.storage_backend_statuses() == jio.storage_backend_statuses()
    assert pio.available_storage_backends() == jio.available_storage_backends()
    assert [s.name for s in pio.storage_backend_statuses()] == sorted(
        set(pio.READER_BACKENDS) & set(pio.WRITER_BACKENDS))
    assert sorted(pio.READER_BACKENDS) == sorted(jio.READER_BACKENDS)
    assert sorted(pio.WRITER_BACKENDS) == sorted(jio.WRITER_BACKENDS)
    kaldi = [s for s in pio.storage_backend_statuses() if s.name == "kaldiio"]
    assert kaldi == [pio.StorageBackendInfo("kaldiio", False, "pip install kaldi_native_io")]
    # Without h5py (hidden from both packages), the HDF5 stores are unavailable.
    monkeypatch.setitem(sys.modules, "h5py", None)
    _clear_module_caches()
    try:
        assert pio.storage_backend_statuses() == jio.storage_backend_statuses()
        assert {s.name for s in pio.storage_backend_statuses() if not s.available} == {
            *HDF5, "kaldiio"}
        assert pio.available_storage_backends() == jio.available_storage_backends()
        for name in HDF5:
            ours = pytest.raises(ValueError, pio.get_writer(name), "x.h5")
            theirs = pytest.raises(ValueError, jio.get_writer(name), "x.h5")
            assert str(ours.value) == str(theirs.value) == (
                "To read and write HDF5 file formats, please 'pip install h5py' first.")
    finally:
        monkeypatch.undo()
        _clear_module_caches()


def test_kaldiio_without_kaldi_native_io_raises_as_jax(tmp_path):
    _clear_module_caches()
    for cls in ("KaldiReader", "KaldiWriter"):
        ours = pytest.raises(ValueError, getattr(pio, cls), tmp_path / "feats.scp")
        theirs = pytest.raises(ValueError, getattr(jio, cls), tmp_path / "feats.scp")
        assert str(ours.value) == str(theirs.value) == (
            "To read Kaldi feats.scp, please 'pip install kaldi_native_io' first.")
    assert pio.get_reader("kaldiio") is pio.KaldiReader
    assert pio.get_writer("kaldiio") is pio.KaldiWriter


def _kaldi_native_io_stub():
    """A ``kaldi_native_io`` that writes each matrix's NPY bytes into
    ``feats.ark`` and ``<key> <ark>:<offset>`` lines into ``feats.scp``, and
    records the compression method it was given."""
    module = types.ModuleType("kaldi_native_io")
    module.__spec__ = importlib.machinery.ModuleSpec("kaldi_native_io", None)
    module.methods = []

    class CompressedMatrixWriter:
        def __init__(self, spec):
            kind, paths = spec.split(":", 1)
            assert kind == "ark,scp"
            self.ark_path, self.scp_path = paths.split(",")
            self.ark, self.scp = open(self.ark_path, "wb"), open(self.scp_path, "w")

        def write(self, key, value, method):
            module.methods.append(method)
            offset = self.ark.tell()
            np.save(self.ark, np.asarray(value, np.float32))
            self.scp.write(f"{key} {self.ark_path}:{offset}\n")

        def close(self):
            self.ark.close()
            self.scp.close()

    class RandomAccessFloatMatrixReader:
        def __init__(self, spec):
            kind, path = spec.split(":", 1)
            assert kind == "scp"
            self.index = dict(line.split() for line in Path(path).read_text().splitlines())

        def __getitem__(self, key):
            ark, offset = self.index[key].rsplit(":", 1)
            with open(ark, "rb") as f:
                f.seek(int(offset))
                return np.load(f)

    module.CompressedMatrixWriter = CompressedMatrixWriter
    module.RandomAccessFloatMatrixReader = RandomAccessFloatMatrixReader
    module.CompressionMethod = lambda value: ("CompressionMethod", value)
    return module


def test_kaldiio_through_one_stub_in_both_packages(tmp_path, monkeypatch):
    stub = _kaldi_native_io_stub()
    monkeypatch.setitem(sys.modules, "kaldi_native_io", stub)
    _clear_module_caches()
    try:
        assert pio.storage_backend_statuses() == jio.storage_backend_statuses()
        assert "kaldiio" in pio.available_storage_backends()
        mats = [_feats((60 + 10 * i, 13), i) for i in range(3)]
        stored = {}
        for label, io_module in (("port", pio), ("jax", jio)):
            with io_module.KaldiWriter(tmp_path / label, compression_method=2) as w:
                keys = [w.write(f"utt-{i}", m) for i, m in enumerate(mats)]
                stored[label] = (keys, w.storage_path)
        assert stub.methods == [("CompressionMethod", 2)] * 6
        assert stored["port"][0] == stored["jax"][0] == ["utt-0", "utt-1", "utt-2"]
        assert stored["port"][1] == str(tmp_path / "port" / "feats.scp")
        for name in ("feats.ark", "feats.scp"):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(
            ).replace(str(tmp_path / "jax").encode(), str(tmp_path / "port").encode())
        for label, (keys, path) in stored.items():
            ours, theirs = pio.KaldiReader(path), jio.KaldiReader(path)
            for key, mat in zip(keys, mats):
                np.testing.assert_array_equal(ours.read(key, 5, 40), theirs.read(key, 5, 40))
                np.testing.assert_array_equal(ours.read(key), mat)
            assert pio.lookup_reader_cache_or_open(path) is ours.storage
    finally:
        monkeypatch.undo()
        _clear_module_caches()


# -- lilcom_url on a local directory -------------------------------------------------------------


def test_lilcom_url_on_a_local_directory_equals_jax(tmp_path):
    mats = [_feats(s, i) for i, s in enumerate(SHAPES)]
    stored = {label: _write(io_module, "lilcom_url", tmp_path / label, mats)
              for label, io_module in (("port", pio), ("jax", jio))}
    assert stored["port"][0] == stored["jax"][0]
    assert stored["port"][1] == str(tmp_path / "port")
    for key in stored["port"][0]:
        assert (tmp_path / "port" / key).read_bytes() == (tmp_path / "jax" / key).read_bytes()
    for label, (keys, path) in stored.items():
        for key, mat in zip(keys, mats):
            ours = pio.LilcomURLReader(path).read(key, 3, 30)
            np.testing.assert_array_equal(ours, jio.LilcomURLReader(path).read(key, 3, 30))
            assert ours.shape == mat[3:30].shape
            assert np.abs(pio.LilcomURLReader(path).read(key) - mat).max() <= 2.0 ** -6 + 1e-6


# -- workarounds ------------------------------------------------------------------------------


def test_gzip_open_robust_tolerates_trailing_garbage_as_jax(tmp_path):
    payload = "".join(f"line {i}\n" for i in range(500)).encode()
    path = tmp_path / "x.gz"
    path.write_bytes(gzip.compress(payload) + b"\x00garbage")
    with pytest.raises(Exception):
        gzip.decompress(path.read_bytes())
    for mode in ("rb", "rt"):
        with pwork.gzip_open_robust(path, mode) as f, jwork.gzip_open_robust(path, mode) as g:
            assert f.read() == g.read() == (payload if mode == "rb" else payload.decode())
    with open(path, "rb") as raw:
        assert pwork.gzip_open_robust(raw).read(100) == payload[:100]
    for args, kw in ((("x", "rbt"), {}), ((path, "rb"), {"encoding": "utf-8"}), ((3,), {})):
        ours = pytest.raises((ValueError, TypeError), pwork.gzip_open_robust, *args, **kw)
        theirs = pytest.raises((ValueError, TypeError), jwork.gzip_open_robust, *args, **kw)
        assert (type(ours.value), str(ours.value)) == (type(theirs.value), str(theirs.value))
    (tmp_path / "bad.gz").write_bytes(b"not gzip at all")
    with pytest.raises(OSError):
        pwork.gzip_open_robust(tmp_path / "bad.gz").read()


def test_hdf5_memory_issue_fix_closes_the_cached_handles(tmp_path):
    (key,), path = _write(pio, "numpy_hdf5", tmp_path / "f", [_feats((10, 2), 0)])
    fix = pwork.Hdf5MemoryIssueFix(reset_interval=3)
    pio.NumpyHdf5Reader(path).read(key)
    for _ in range(3):
        fix.update()
    assert pio.lookup_cache_or_open.cache_info().currsize == 1 and fix.counter == 3
    fix.update()
    assert pio.lookup_cache_or_open.cache_info().currsize == 0 and fix.counter == 1


# -- CutSet.copy_feats and the commands ------------------------------------------------------


@pytest.fixture(scope="module")
def stored_cuts(tmp_path_factory):
    """Four cuts with features of 120-260 frames in two JAX-written
    ``lilcom_chunky`` archives (two cuts each), as a CutSet manifest and a
    FeatureSet manifest."""
    root = tmp_path_factory.mktemp("copy_feats")
    feats = []
    for part in range(2):
        with jio.LilcomChunkyWriter(root / f"part{part}") as w:
            for j in range(2):
                i = 2 * part + j
                mat = _feats((120 + 40 * i, 20), 10 + i)
                feats.append(J.Features(
                    type="kaldi-fbank", num_frames=mat.shape[0], num_features=20,
                    frame_shift=0.01, sampling_rate=16000, start=0.0, duration=mat.shape[0] / 100,
                    storage_type=w.name, storage_path=w.storage_path,
                    storage_key=w.write(f"utt-{i}", mat), recording_id=f"rec-{i}", channels=0))
    cuts = J.CutSet.from_cuts(
        J.MonoCut(id=f"cut-{i}", start=0.0, duration=f.duration, channel=0, features=f)
        for i, f in enumerate(feats))
    cuts.to_file(root / "cuts.jsonl.gz")
    J.FeatureSet.from_features(feats).to_file(root / "feats.jsonl.gz")
    return root


def _swapped(path, out: Path, label: str):
    """A manifest's items as dicts, with ``out`` in their paths replaced."""
    with gzip.open(path, "rt") if str(path).endswith(".gz") else open(path) as f:
        return [json.loads(line.replace(str(out), f"<{label}>").replace(f"<{label}>", "<out>"))
                for line in f]


@pytest.mark.parametrize("storage_type", [
    "lilcom_files", "numpy_files", "lilcom_url", "lilcom_chunky", *HDF5])
def test_cutset_copy_feats_equals_jax(stored_cuts, tmp_path, storage_type):
    from lhotse_tpu.utils import fix_random_seed as jfix
    from lhotse_tpu_torch.utils import fix_random_seed

    out = {}
    for label, module, io_module, seed in (("port", P, pio, fix_random_seed),
                                            ("jax", J, jio, jfix)):
        seed(0)
        (tmp_path / label).mkdir()
        cuts = module.CutSet.from_file(stored_cuts / "cuts.jsonl.gz")
        # A MixedCut (a cut padded to 3 s) copies its data track's features.
        cuts = module.CutSet.from_cuts(list(cuts)[1:] + [cuts[0].pad(duration=3.0)])
        padded_before = cuts[-1].to_dict()
        with io_module.get_writer(storage_type)(tmp_path / label / "store") as w:
            copied = cuts.copy_feats(writer=w, output_path=tmp_path / label / "cuts.jsonl.gz")
        out[label] = list(copied)
        assert type(out[label][-1]).__name__ == "MixedCut"
        # The port leaves the input's tracks as they were; the JAX package
        # rewrites them in place (ROADMAP.md C2).
        assert (cuts[-1].to_dict() == padded_before) is (label == "port")
    for label in out:
        assert _swapped(tmp_path / label / "cuts.jsonl.gz", tmp_path / label, label) == _swapped(
            tmp_path / "jax" / "cuts.jsonl.gz", tmp_path / "jax", "jax")
    source = list(P.CutSet.from_file(stored_cuts / "cuts.jsonl.gz"))
    for ours, theirs, orig in zip(out["port"], out["jax"], source[1:] + source[:1]):
        np.testing.assert_array_equal(ours.load_features(), theirs.load_features())
        got = (ours.tracks[0].cut if type(ours).__name__ == "MixedCut" else ours).load_features()
        before = orig.load_features()
        if storage_type.startswith("numpy"):
            np.testing.assert_array_equal(got, before)
        else:
            assert np.abs(got - before).max() <= 2.0 ** -6 + 1e-6
    pio.close_cached_file_handles()
    jio.close_cached_file_handles()


def _run(cli, args):
    res = CliRunner().invoke(cli, [str(a) for a in args])
    assert res.exit_code == 0, (res.output, res.exception)
    return res


@pytest.mark.parametrize("storage_type", ["lilcom_files", "numpy_files", "lilcom_url", *HDF5])
def test_copy_feats_command_equals_jax(stored_cuts, tmp_path, storage_type):
    """A CutSet manifest over two archives, one job per archive (the port
    copies in this process with ``-j 1``), and a FeatureSet manifest."""
    for label, cli in (("port", pcli), ("jax", jcli)):
        out = tmp_path / label
        out.mkdir()
        _run(cli, ["copy-feats", stored_cuts / "cuts.jsonl.gz", out / "cuts.jsonl.gz",
                   out / "store", "-t", storage_type, "-j", "1"])
        _run(cli, ["copy-feats", stored_cuts / "feats.jsonl.gz", out / "feats.jsonl.gz",
                   out / "fstore", "-t", storage_type])
    for name in ("cuts.jsonl.gz", "feats.jsonl.gz", "store/cuts-0.jsonl.gz",
                 "store/cuts-1.jsonl.gz"):
        assert _swapped(tmp_path / "port" / name, tmp_path / "port", "port") == _swapped(
            tmp_path / "jax" / name, tmp_path / "jax", "jax"), name
    ours = P.CutSet.from_file(tmp_path / "port" / "cuts.jsonl.gz")
    source = {c.id: c for c in P.CutSet.from_file(stored_cuts / "cuts.jsonl.gz")}
    assert sorted(c.id for c in ours) == sorted(source)
    for cut in ours:
        assert cut.features.storage_type == storage_type
        got, before = cut.load_features(), source[cut.id].load_features()
        if storage_type.startswith("numpy"):
            np.testing.assert_array_equal(got, before)
        else:
            assert np.abs(got - before).max() <= 2.0 ** -6 + 1e-6
    for f, g in zip(P.FeatureSet.from_file(tmp_path / "port" / "feats.jsonl.gz"),
                    J.FeatureSet.from_file(tmp_path / "jax" / "feats.jsonl.gz")):
        np.testing.assert_array_equal(f.load(), g.load())
    pio.close_cached_file_handles()
    jio.close_cached_file_handles()


def test_copy_feats_command_in_spawned_workers(stored_cuts, tmp_path):
    """Two archives and two jobs: the port's workers are spawned; the merged
    manifest holds every cut once, as JAX's forked workers' does."""
    for label, cli in (("port", pcli), ("jax", jcli)):
        (tmp_path / label).mkdir()
        _run(cli, ["copy-feats", stored_cuts / "cuts.jsonl.gz", tmp_path / label / "cuts.jsonl",
                   tmp_path / label / "store", "-t", "numpy_files", "-j", "2"])
    key = lambda d: d["id"]  # noqa: E731 - the workers finish in any order
    assert sorted(_swapped(tmp_path / "port" / "cuts.jsonl", tmp_path / "port", "port"),
                  key=key) == sorted(
        _swapped(tmp_path / "jax" / "cuts.jsonl", tmp_path / "jax", "jax"), key=key)


def test_copy_feats_command_refuses_what_jax_refuses(stored_cuts, tmp_path):
    J.RecordingSet.from_recordings([]).to_file(tmp_path / "recs.jsonl.gz")
    for cli in (pcli, jcli):
        res = CliRunner().invoke(cli, ["copy-feats", str(tmp_path / "recs.jsonl.gz"),
                                       str(tmp_path / "o.jsonl.gz"), str(tmp_path / "s")])
        assert res.exit_code != 0
        assert isinstance(res.exception, ValueError) and "Unsupported manifest type" in str(
            res.exception)
        res = CliRunner().invoke(cli, ["copy-feats", str(stored_cuts / "cuts.jsonl.gz"),
                                       str(tmp_path / "o.jsonl.gz"), str(tmp_path / "s"), "-t",
                                       "no_such_store"])
        assert res.exit_code == 2 and "no_such_store" in res.output


def test_feat_upload_equals_jax(stored_cuts, tmp_path):
    for label, cli in (("port", pcli), ("jax", jcli)):
        (tmp_path / label).mkdir()
        _run(cli, ["feat", "upload", stored_cuts / "feats.jsonl.gz", tmp_path / label / "remote",
                   tmp_path / label / "out.jsonl.gz"])
    assert _swapped(tmp_path / "port" / "out.jsonl.gz", tmp_path / "port", "port") == _swapped(
        tmp_path / "jax" / "out.jsonl.gz", tmp_path / "jax", "jax")
    for orig, new in zip(P.FeatureSet.from_file(stored_cuts / "feats.jsonl.gz"),
                         P.FeatureSet.from_file(tmp_path / "port" / "out.jsonl.gz")):
        assert new.storage_type == "lilcom_url"
        assert np.abs(orig.load() - new.load()).max() <= 2.0 ** -6 + 1e-6
    for cli in (pcli, jcli):
        res = CliRunner().invoke(cli, ["feat", "upload", str(stored_cuts / "feats.jsonl.gz"),
                                       str(tmp_path / "r"), str(tmp_path / "out.json")])
        assert isinstance(res.exception, AssertionError)
