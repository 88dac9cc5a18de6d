"""
The port's host DSP library (lhotse_tpu_torch.ops.host_dsp over
native/dsp/dsp_kernels.c) against the JAX package's: the adpcm4 and mu-law
wire encoders give the bytes of the JAX package's native encoders and of the
numpy encoders, on rows with clipped ±1 edges and on silence; ``encode_wire``
reaches the C encoders; the FLAC decoder's PCM scaling is the numpy product.
"""
import numpy as np
import pytest

from lhotse_tpu.ops import host_dsp as jhost_dsp
from lhotse_tpu.ops import wire as jwire
from lhotse_tpu_torch.native_build import NATIVE_ROOT
from lhotse_tpu_torch.ops import host_dsp, wire


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    """Byte equality is against the JAX package's native encoders: check that
    its library was built rather than assume it."""
    assert jhost_dsp.is_available()
    assert jhost_dsp._get_lib().adpcm4_encode_f32 is not None


def test_source_is_a_byte_for_byte_copy():
    from pathlib import Path

    import lhotse_tpu

    jax_src = Path(lhotse_tpu.__file__).parent / "native" / "dsp" / "dsp_kernels.c"
    assert (NATIVE_ROOT / "dsp" / "dsp_kernels.c").read_bytes() == jax_src.read_bytes()


def _rows(kind: str, T: int = 64 * 50) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "silence":
        return np.zeros((3, T), np.float32)
    if kind == "clipped":
        # Past full scale at both edges: the encoders clip to int16 there.
        x = 1.4 * np.sin(2 * np.pi * 7 * np.arange(T) / T)[None, :] * np.ones((4, 1))
        x[:, :64] = 1.0
        x[:, -64:] = -1.0
        x[1, ::5] = -1.2
        return x.astype(np.float32)
    x = 0.3 * rng.standard_normal((5, T)) + 0.2 * np.sin(np.arange(T) / 9.0)
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["speech", "clipped", "silence"])
def test_adpcm4_encode_equals_jax_native_and_numpy(kind):
    x = _rows(kind)
    ours = wire._adpcm4_encode(x)
    assert np.array_equal(ours, jwire._adpcm4_encode(x))  # the JAX package's native encoder
    assert np.array_equal(ours, wire._adpcm4_encode_np(x))
    nb, width = wire._adpcm4_geometry(x.shape[-1])
    assert np.array_equal(ours, jhost_dsp.adpcm4_encode(x, x.shape[-1], width))
    # 3-D leading shape: rows are flattened and restored.
    assert np.array_equal(wire._adpcm4_encode(x[None]), ours[None])


@pytest.mark.parametrize("kind", ["speech", "clipped", "silence"])
def test_mulaw_encode_equals_jax_native_and_numpy(kind):
    x = _rows(kind)
    ours = wire._mulaw_encode(x)
    assert ours.dtype == np.uint8
    assert np.array_equal(ours, jwire._mulaw_encode(x))
    assert np.array_equal(ours, wire._mulaw_encode_np(x))
    jwire._mulaw_encode(x[:1])  # builds the JAX LUT
    assert np.array_equal(wire._MULAW_LUT, jwire._MULAW_LUT)


@pytest.mark.parametrize("fmt,fn", [("adpcm4", "adpcm4_encode"), ("mulaw", "mulaw_encode_lut")])
def test_encode_wire_reaches_the_c_encoder(monkeypatch, fmt, fn):
    calls = []
    real = getattr(host_dsp, fn)

    def counting(*a, **kw):
        calls.append(fn)
        return real(*a, **kw)

    monkeypatch.setattr(host_dsp, fn, counting)
    x = _rows("speech")
    assert np.array_equal(wire.encode_wire(x, fmt), jwire.encode_wire(x, fmt))
    assert calls == [fn]


def test_scale_i32_to_f32_equals_numpy_and_jax():
    pcm = np.random.default_rng(0).integers(-(2**23), 2**23, size=(1000, 2), dtype=np.int32)
    scale = 1.0 / float(1 << 23)
    ours = host_dsp.scale_i32_to_f32(pcm, scale)
    assert ours.dtype == np.float32 and ours.shape == pcm.shape
    assert np.array_equal(ours, pcm.astype(np.float32) * np.float32(scale))
    assert np.array_equal(ours, jhost_dsp.scale_i32_to_f32(pcm, scale))
