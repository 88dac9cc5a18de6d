"""
The port's WPE (lhotse_tpu_torch.ops.wpe) on the CPU: held to
tests/test_ops_wpe.py's criteria against the float64 host WPE, and to a
stated bound against the JAX package's ``dereverb_wpe_jax`` on the same
seeded reverberant audio.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from lhotse_tpu.augmentation.wpe import dereverb_wpe_numpy  # noqa: E402
from lhotse_tpu.ops.wpe import dereverb_wpe_jax  # noqa: E402
from lhotse_tpu_torch.ops import wpe as P  # noqa: E402
from test_ops_wpe import SR, _reverberant  # noqa: E402

# Against the JAX function, whose complex64 fixed-point iterations amplify
# rounding on ill-conditioned bins (a 1e-6 relative change of this input
# moves its output by ≈ 2 %). Measured relative error 0.027 (1 channel) /
# 0.026 (2 channels), correlation 0.9996 / 0.9997.
JAX_REL, JAX_CORR = 0.1, 0.99


def _wpe(audio, **kw):
    return P.dereverb_wpe(audio, device="cpu", **kw).numpy()


@pytest.mark.parametrize("channels", [1, 2])
def test_matches_host_wpe(channels):
    """tests/test_ops_wpe.py::test_matches_host_wpe's criteria."""
    audio = _reverberant(channels=channels)
    host = dereverb_wpe_numpy(audio)
    ours = _wpe(audio)
    assert ours.shape == host.shape and ours.dtype == np.float32
    assert np.corrcoef(ours.ravel(), host.ravel())[0, 1] > 0.95
    assert np.linalg.norm(ours - host) / np.linalg.norm(host) < 0.4
    e_in, e_ours, e_host = (float(np.sum(a ** 2)) for a in (audio, ours, host))
    assert e_ours < 0.5 * e_in and e_ours < 2.0 * e_host


@pytest.mark.parametrize("channels", [1, 2])
def test_matches_jax_wpe(channels):
    audio = _reverberant(channels=channels)
    theirs = np.asarray(dereverb_wpe_jax(audio))
    ours = _wpe(audio)
    assert np.linalg.norm(ours - theirs) / np.linalg.norm(theirs) < JAX_REL
    assert np.corrcoef(ours.ravel(), theirs.ravel())[0, 1] > JAX_CORR


@pytest.mark.parametrize("channels", [1, 2])
def test_stft_and_istft_stages_match_jax(channels):
    """With no iteration the solves never run: what is left is the STFT,
    the per-bin normalisation and the iSTFT, which reconstruct the input."""
    audio = _reverberant(channels=channels, seed=7)
    theirs = np.asarray(dereverb_wpe_jax(audio, iterations=0))
    ours = _wpe(audio, iterations=0)
    assert np.abs(ours - theirs).max() <= 1e-5
    assert np.abs(ours - audio).max() <= 1e-5


def test_stft_frames_and_bins():
    x = torch.from_numpy(_reverberant(channels=2, seconds=0.5))
    spec = P.stft(x, 512, 128)
    assert spec.dtype == torch.complex64
    assert spec.shape == (2, 257, 1 + x.shape[-1] // 128)
    torch.testing.assert_close(P.istft(spec, x.shape[-1], 512, 128), x, rtol=0, atol=1e-5)


def test_stable_under_rounding_at_10_s():
    """The per-bin work runs in complex128: a 1e-6 relative change of a
    tonal 2-channel 10 s input moves the output by < 2 % (measured 0.7 %);
    in complex64 it moved it by 57 %, and the card and the CPU gave
    unrelated outputs."""
    audio = _reverberant(channels=2, seconds=10.0)
    noise = np.random.default_rng(1).standard_normal(audio.shape)
    perturbed = (audio * (1 + 1e-6 * noise)).astype(np.float32)
    a, b = _wpe(audio), _wpe(perturbed)
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 0.02
    assert np.sum(a ** 2) < 0.5 * np.sum(audio ** 2)


def test_reduces_reverberant_tail_energy():
    audio = _reverberant(channels=2, seconds=1.5, seed=3)
    out = _wpe(audio)
    assert np.sum(out ** 2) < np.sum(audio ** 2)
    assert np.isfinite(out).all()


def test_batched_input_matches_per_item():
    a = _reverberant(channels=1, seed=4)
    b = _reverberant(channels=1, seed=5)
    batched = _wpe(np.stack([a, b]))
    assert batched.shape == (2, 1, SR)
    np.testing.assert_allclose(batched[0], _wpe(a), atol=1e-6)
    np.testing.assert_allclose(batched[1], _wpe(b), atol=1e-6)


def test_silence_passthrough():
    audio = np.zeros((1, SR // 2), np.float32)
    out = _wpe(audio)
    assert out.shape == audio.shape
    np.testing.assert_allclose(out, 0.0, atol=1e-6)


def test_tensor_runs_where_it_lives_and_arrays_default_to_the_card():
    audio = _reverberant(channels=1, seconds=0.25)
    out = P.dereverb_wpe(torch.from_numpy(audio))
    assert out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), _wpe(audio))
    with pytest.raises(ValueError, match=r"\(C, N\)"):
        P.dereverb_wpe(torch.zeros(SR))
    with pytest.raises(ValueError, match="hop"):
        P.dereverb_wpe(torch.from_numpy(audio), hop_length=100)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        P.dereverb_wpe(audio)
