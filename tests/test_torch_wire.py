"""The port's wire formats (lhotse_tpu_torch.ops.wire) against the JAX package's."""
import numpy as np
import pytest
import torch

from lhotse_tpu.ops import wire as jw
from lhotse_tpu_torch.ops import wire as tw

FORMATS = ["float32", "int16", "mulaw", "adpcm4"]


def _audio():
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((3, 64 * 63))).astype(np.float32)  # whole adpcm4 blocks
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


def _adpcm_cases():
    """Noise, clipping and silence at several row counts (T a multiple of 64)."""
    rng = np.random.default_rng(3)
    noise = (0.3 * rng.standard_normal((5, 64 * 40))).astype(np.float32)
    clipped = np.clip(3.0 * rng.standard_normal((2, 64 * 8)), -2.0, 2.0).astype(np.float32)
    clipped[0, :64] = 1.5  # a whole block past full scale
    silence = np.zeros((3, 64 * 4), np.float32)
    mixed = noise[:1, : 64 * 6].copy()
    mixed[0, 64:192] = 0.0  # silence between loud blocks
    tone = (0.9 * np.sin(np.arange(64 * 20) * 0.3)).astype(np.float32)[None, :]
    return {"noise": noise, "clipped": clipped, "silence": silence, "mixed": mixed,
            "tone": tone, "one_row_1d": noise[0]}


ADPCM_CASES = sorted(_adpcm_cases())


@pytest.mark.parametrize("case", ADPCM_CASES)
def test_adpcm4_encode_equals_jax(case):
    audio = _adpcm_cases()[case]
    ours, theirs = tw.encode_wire(audio, "adpcm4"), jw.encode_wire(audio, "adpcm4")
    assert ours.dtype == theirs.dtype == np.uint8
    assert ours.shape == theirs.shape == audio.shape[:-1] + (
        tw.wire_row_width(audio.shape[-1], "adpcm4"),)
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("case", ADPCM_CASES)
def test_adpcm4_decode_bit_exact(case):
    wire = jw.encode_wire(_adpcm_cases()[case], "adpcm4")
    ours = tw.decode_wire(torch.from_numpy(wire), "adpcm4")
    assert ours.dtype == torch.float32
    assert torch.equal(ours, torch.from_numpy(jw.adpcm4_decode_np(wire)))
    assert torch.equal(ours, torch.from_numpy(np.asarray(jw.decode_wire(wire, "adpcm4"))))
    assert np.array_equal(tw.adpcm4_decode_np(wire), jw.adpcm4_decode_np(wire))


def test_adpcm4_decode_random_bytes():
    """Every header and nibble value, not only those an encoder emits: the
    step index saturates at both ends and the predictor clips."""
    wire = np.random.default_rng(4).integers(0, 256, (6, 36 * 10), dtype=np.uint8)
    ours = tw.decode_wire(torch.from_numpy(wire), "adpcm4")
    assert torch.equal(ours, torch.from_numpy(jw.adpcm4_decode_np(wire)))


@pytest.mark.parametrize("call", [
    lambda: tw.encode_wire(np.zeros((1, 100), np.float32), "adpcm4"),
    lambda: tw.wire_row_width(16001, "adpcm4"),
])
def test_adpcm4_needs_whole_blocks(call):
    with pytest.raises(ValueError, match="T % 64 == 0"):
        call()


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="Unknown wire format"):
        tw.encode_wire(np.zeros(4, np.float32), "opus")
