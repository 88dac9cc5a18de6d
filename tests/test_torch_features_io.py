"""
The port's LTC1 codec (lhotse_tpu_torch.codecs over native/lilcom/ltc1.c)
and feature storage (lhotse_tpu_torch.features.io) against the JAX
package's: ``compress`` gives the JAX package's bytes (its native codec,
checked to be built) for float32 and float64, 1-D to 3-D, at tick powers -5
and -8; the same bytes decode to the same arrays in both packages and in the
numpy decoders; every ported backend round-trips, and each package reads
what the other wrote, with left and right frame offsets and windows that
start mid-chunk.
"""
from pathlib import Path

import numpy as np
import pytest

import lhotse_tpu
from lhotse_tpu.codecs import lilcom_codec as jcodec
from lhotse_tpu.features import io as jio
from lhotse_tpu_torch.codecs import lilcom_codec as codec
from lhotse_tpu_torch.features import io
from lhotse_tpu_torch.native_build import NATIVE_ROOT


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    """The JAX package writes method 1 only with its native codec built
    (lilcom_codec.py:113-128): check that it was built."""
    assert jcodec._native_lib() is not None


def test_source_is_a_byte_for_byte_copy():
    jax_src = Path(lhotse_tpu.__file__).parent / "native" / "lilcom" / "ltc1.c"
    assert (NATIVE_ROOT / "lilcom" / "ltc1.c").read_bytes() == jax_src.read_bytes()


def _feats(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).cumsum(axis=0) * 0.3 - 4.0
    return x.astype(dtype)


SHAPES = [(1300,), (1300, 80), (37, 5, 3), (1, 80)]


@pytest.mark.parametrize("tick_power", [-5, -8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_compress_bytes_equal_jax(shape, dtype, tick_power):
    x = _feats(shape, dtype)
    ours = codec.compress(x, tick_power=tick_power)
    assert ours == jcodec.compress(x, tick_power=tick_power)
    # float32 takes the C codec's row packing, float64 numpy's deflate.
    assert ours[4] == (1 if dtype == np.float32 else 0)
    decoded = codec.decompress(ours)
    assert decoded.dtype == np.float32 and decoded.shape == shape
    assert np.array_equal(decoded, jcodec.decompress(ours))
    assert np.array_equal(decoded, codec._decompress_numpy(ours))
    assert np.array_equal(decoded, codec.decompress(ours))  # decoding twice: the same array
    assert np.abs(decoded - x).max() <= 2.0 ** (tick_power - 1) + 1e-6


def test_decompress_concat_equals_jax_and_per_chunk():
    x = _feats((1300, 80), np.float32)
    chunks = [codec.compress(x[i : i + 500]) for i in range(0, 1300, 500)]
    blob = b"".join(chunks)
    ours = codec.decompress_concat(blob, [len(c) for c in chunks], max_rows=1500)
    assert np.array_equal(ours, jcodec.decompress_concat(blob, [len(c) for c in chunks], max_rows=1500))
    assert np.array_equal(ours, np.concatenate([codec.decompress(c) for c in chunks]))
    assert codec.decompress_concat(b"NOPE" + blob[4:], [len(blob)], 1500) is None


def test_non_ltc1_payload_raises_without_pip_lilcom():
    from lhotse_tpu_torch.utils import is_module_available

    if is_module_available("lilcom"):
        pytest.skip("the pip lilcom package is installed here")
    with pytest.raises(ValueError, match="LTC1"):
        codec.decompress(b"\x00" * 16)


FILE_BACKENDS = ["lilcom_chunky", "lilcom_files", "numpy_files"]
MEMORY_BACKENDS = ["memory_lilcom", "memory_raw", "memory_npy"]
WINDOWS = [(0, None), (480, 1020), (501, None), (0, 37), (1000, 1300)]


def _write(pkg, name, path, arrays):
    with pkg.get_writer(name)(str(path)) as writer:
        keys = [writer.write(f"utt{i}", a) for i, a in enumerate(arrays)]
        storage_path = writer.storage_path
    return storage_path, keys


@pytest.mark.parametrize("name", FILE_BACKENDS + MEMORY_BACKENDS)
@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_backends_read_what_either_package_wrote(tmp_path, name, writer_pkg):
    arrays = [_feats((1300, 80), np.float32, seed=1), _feats((700, 80), np.float32, seed=2)]
    wpkg, rpkgs = (io, (io, jio)) if writer_pkg == "port" else (jio, (io, jio))
    storage_path, keys = _write(wpkg, name, tmp_path / "feats", arrays)
    lossy = "lilcom" in name
    for key, arr in zip(keys, arrays):
        outs = []
        for pkg in rpkgs:
            reader = pkg.get_reader(name)(storage_path)
            for left, right in WINDOWS:
                if left >= arr.shape[0]:
                    continue
                got = reader.read(key, left_offset_frames=left, right_offset_frames=right)
                want = arr[left:right]
                assert got.shape == want.shape
                if lossy:
                    assert np.abs(got - want).max() <= 2.0**-6 + 1e-6
                else:
                    assert np.array_equal(got, want)
                outs.append(got)
        # Both packages decode the same bytes to the same arrays.
        half = len(outs) // 2
        assert all(np.array_equal(a, b) for a, b in zip(outs[:half], outs[half:]))


def test_chunky_bytes_equal_jax(tmp_path):
    arrays = [_feats((1300, 80), np.float32, seed=1), _feats((3, 80), np.float32, seed=4)]
    ours_path, ours_keys = _write(io, "lilcom_chunky", tmp_path / "ours", arrays)
    jax_path, jax_keys = _write(jio, "lilcom_chunky", tmp_path / "jax", arrays)
    assert ours_keys == jax_keys
    assert Path(ours_path).read_bytes() == Path(jax_path).read_bytes()
    assert ours_path.endswith(".lca")


def test_store_array_and_temporal_array_load(tmp_path):
    from lhotse_tpu.array import TemporalArray as JTemporalArray

    arr = _feats((1300, 80), np.float32)
    with io.LilcomChunkyWriter(tmp_path / "arr") as writer:
        plain = writer.store_array("a", arr[:10])
        temporal = writer.store_array("b", arr, frame_shift=0.01, temporal_dim=0, start=2.0)
    assert np.abs(plain.load() - arr[:10]).max() <= 2.0**-6
    got = temporal.load(start=6.8, duration=5.4)
    assert got.shape == (540, 80)
    jgot = JTemporalArray.from_dict(temporal.to_dict()).load(start=6.8, duration=5.4)
    assert np.array_equal(got, jgot)
    with pytest.raises(AssertionError):
        writer.store_array("c", arr, frame_shift=0.01)


@pytest.mark.parametrize("name", ["lilcom_hdf5", "numpy_hdf5", "chunked_lilcom_hdf5", "kaldiio",
                                  "lilcom_url", "shar"])
def test_backends_not_ported_raise(name):
    if name == "shar":
        # The Shar placeholder reader is ported: it raises when read, as the
        # JAX package's does, and no writer has the name.
        with pytest.raises(RuntimeError, match="Shar placeholder"):
            io.get_reader(name)().read("key")
        with pytest.raises(KeyError, match=name):
            io.get_writer(name)
        return
    with pytest.raises(NotImplementedError, match=name):
        io.get_reader(name)
    with pytest.raises(NotImplementedError, match=name):
        io.get_writer(name)


def test_default_backend_and_env(monkeypatch):
    monkeypatch.delenv("LHOTSE_TPU_FEATURES_STORAGE_BACKEND", raising=False)
    monkeypatch.delenv("LHOTSE_FEATURES_STORAGE_BACKEND", raising=False)
    assert io.default_features_storage_backend_name() == "lilcom_chunky"
    assert io.default_features_storage_backend() is io.LilcomChunkyWriter
    monkeypatch.setenv("LHOTSE_FEATURES_STORAGE_BACKEND", "numpy_files")
    assert io.default_features_storage_backend_name() == jio.default_features_storage_backend_name()
    monkeypatch.setenv("LHOTSE_TPU_FEATURES_STORAGE_BACKEND", "lilcom_files")
    assert io.default_features_storage_backend_name() == "lilcom_files"
    assert sorted(io.available_storage_backends()) == sorted(
        n for n in jio.available_storage_backends() if n in FILE_BACKENDS + MEMORY_BACKENDS)
