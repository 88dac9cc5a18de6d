"""The port's wire formats (lhotse_tpu_torch.ops.wire) against the JAX package's."""
import numpy as np
import pytest
import torch

from lhotse_tpu.ops import wire as jw
from lhotse_tpu_torch.ops import wire as tw

FORMATS = ["float32", "int16", "mulaw"]


def _audio():
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((3, 4000))).astype(np.float32)
    x[0, :8] = [-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2 ** -16]  # clipping and tiny values
    return x


@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_equals_jax(fmt):
    ours, theirs = tw.encode_wire(_audio(), fmt), jw.encode_wire(_audio(), fmt)
    assert ours.dtype == theirs.dtype == tw.wire_np_dtype(fmt)
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("fmt", ["float32", "int16"])
def test_round_trip_bit_exact(fmt):
    wire = jw.encode_wire(_audio(), fmt)
    ours = tw.decode_wire(torch.from_numpy(wire), fmt)
    assert ours.dtype == torch.float32
    assert np.array_equal(ours.numpy(), np.asarray(jw.decode_wire(wire, fmt)))


def test_mulaw_decode_matches():
    wire = jw.encode_wire(_audio(), "mulaw")
    ours = tw.decode_wire(torch.from_numpy(wire), "mulaw").numpy()
    np.testing.assert_allclose(ours, np.asarray(jw.decode_wire(wire, "mulaw")), rtol=0, atol=1e-6)
    # Every one of the 256 codes, not only those the audio hit.
    codes = np.arange(256, dtype=np.uint8)[None, :]
    np.testing.assert_allclose(
        tw.decode_wire(torch.from_numpy(codes), "mulaw").numpy(),
        np.asarray(jw.decode_wire(codes, "mulaw")), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fmt", FORMATS)
def test_geometry_equals_jax(fmt):
    assert tw.wire_row_width(16000, fmt) == jw.wire_row_width(16000, fmt)
    assert tw.wire_np_dtype(fmt) == jw.wire_np_dtype(fmt)
    assert tw.wire_bytes_per_sample(fmt) == jw.wire_bytes_per_sample(fmt)


@pytest.mark.parametrize("call", [
    lambda: tw.encode_wire(np.zeros((1, 64), np.float32), "adpcm4"),
    lambda: tw.decode_wire(torch.zeros(1, 36, dtype=torch.uint8), "adpcm4"),
    lambda: tw.wire_row_width(64, "adpcm4"),
    lambda: tw.wire_np_dtype("adpcm4"),
    lambda: tw.wire_bytes_per_sample("adpcm4"),
])
def test_adpcm4_not_ported_yet(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call()


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="Unknown wire format"):
        tw.encode_wire(np.zeros(4, np.float32), "opus")
