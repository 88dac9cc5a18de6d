"""
The port's Kaldi feature layers (lhotse_tpu_torch.features.kaldi.layers)
against the JAX package's, on the CPU at dither=0, and the carrying of a JAX
layer's constant arrays into the port (lhotse_tpu_torch.convert).
"""
import numpy as np
import pytest
import torch

from lhotse_tpu.features.kaldi import layers as jl
from lhotse_tpu_torch.convert import load_numpy_state
from lhotse_tpu_torch.features.kaldi import layers as tl

# The feature parity budget (BASELINE.md): fp32 sums in another order,
# through a log. Linear outputs also get 1e-5 relative.
ATOL, RTOL = 1e-4, 1e-5

LAYERS = [
    ("Wav2LogFilterBank", {}),
    ("Wav2LogFilterBank", {"use_energy": True}),
    ("Wav2LogFilterBank", {"num_filters": 40, "torchaudio_compatible_mel_scale": False}),
    ("Wav2MFCC", {}),
    ("Wav2MFCC", {"cepstral_lifter": 0, "use_energy": True}),
    ("Wav2Spec", {}),
    ("Wav2Spec", {"use_fft_mag": True, "use_energy": False}),
    ("Wav2LogSpec", {}),
    ("Wav2Win", {}),
    ("Wav2Win", {"return_log_energy": True, "raw_energy": False}),
    ("Wav2FFT", {}),
]


def _audio(n, b=2, seed=0):
    return (0.05 * np.random.default_rng(seed + n).standard_normal((b, n))).astype(np.float32)


def _compare(ours, theirs):
    if isinstance(theirs, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _compare(a, b)
        return
    if theirs is None:
        assert ours is None
        return
    theirs = np.asarray(theirs)
    ours = ours.numpy()
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)


def _jax_fused_route(layer, x):
    """The JAX layer's kernel route (what it computes on a TPU), evaluated
    with the JAX package's own XLA ops: frames of the symmetric-padded audio
    through the folded matrices, power, mel, log (then DCT and lifter)."""
    import jax.numpy as jnp
    from lhotse_tpu.ops import fbank as jops

    Mc, Ms, fb, n_mels = layer._fused_matrices()
    frames = jops.frame_signal(jnp.asarray(x), 400, 160, layer.wav2win.snip_edges)
    logmel = jops.mel_fbank_from_power(jops.power_spectrum_gemm(frames, Mc, Ms), fb[:, :n_mels])
    if isinstance(layer, jl.Wav2MFCC):
        return jops.mfcc_from_logmel(logmel, layer._dct, layer._lifter)
    return logmel


@pytest.mark.parametrize("n", [16000, 12345, 999])
@pytest.mark.parametrize("name,kwargs", LAYERS, ids=[f"{n}{k}" for n, k in LAYERS])
def test_layer_matches_jax(name, kwargs, n):
    x = _audio(n)
    theirs = getattr(jl, name)(**kwargs)
    ours = getattr(tl, name)(**kwargs, device="cpu")(torch.from_numpy(x))
    if name == "Wav2LogSpec":
        # The log of a single DFT bin's power has no averaging over a mel
        # band: where a bin nearly cancels, float32 rounding in either
        # package shows up to 2.4e-4 in the log (n=12345). The bound is the
        # JAX package's own for two float32 chains (tests/test_kaldi_features.py).
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs(x)), atol=5e-4, rtol=1e-4)
        return
    if getattr(theirs, "_fused_matrices", lambda: None)() is None:
        _compare(ours, theirs(x))  # the same algorithm as the JAX layer on the CPU
        return
    # The port takes the kernel route on every device; the JAX layer takes
    # it on a TPU only. Like for like, that route within the 1e-4 budget.
    _compare(ours, _jax_fused_route(theirs, x))
    # Against the JAX layer's CPU route (explicit preprocessing, then the
    # raw DFT), the bound is the JAX package's own for two float32 chains
    # (tests/test_kaldi_features.py): in near-silent low mel bins that route
    # is up to 2.4e-4 from a float64 computation, the kernel route 1.5e-5.
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs(x)), atol=5e-4, rtol=1e-4)


def test_fused_route_matches_configuration():
    """Exactly the configurations the JAX layer maps onto its kernel take
    the port's kernel route."""
    for name, kwargs in LAYERS:
        if name not in ("Wav2LogFilterBank", "Wav2MFCC"):
            continue
        jax_route = getattr(jl, name)(**kwargs)._fused_matrices() is not None
        ours = getattr(tl, name)(**kwargs, device="cpu")
        assert (ours._fused_matrices() is not None) == jax_route, (name, kwargs)
        if jax_route:
            assert ours._fused_matrices()[2].shape == (256, ours.num_filters)


def test_one_dim_input_and_dither_needs_generator():
    x = _audio(16000, b=1)[0]
    ours = tl.Wav2LogFilterBank(device="cpu")(torch.from_numpy(x))
    _compare(ours, jl.Wav2LogFilterBank()(x))
    with pytest.raises(ValueError, match="Generator"):
        tl.Wav2LogFilterBank(dither=1.0, device="cpu")
    g = torch.Generator().manual_seed(0)
    a = tl.Wav2LogFilterBank(dither=1e-3, generator=g, device="cpu")(torch.from_numpy(x))
    assert a.shape == ours.shape and not torch.equal(a, ours)


@pytest.mark.parametrize("name", ["Wav2LogFilterBank", "Wav2MFCC", "Wav2Win"])
def test_online_inference_chunked_equals_one_shot(name):
    x = _audio(16000)
    ours = getattr(tl, name)(device="cpu")
    theirs = getattr(jl, name)()
    chunks, context, jchunks, jcontext = [], None, [], None
    for lo, hi in [(0, 5000), (5000, 10000), (10000, 16000)]:
        out, context = ours.online_inference(torch.from_numpy(x[:, lo:hi]), context=context)
        jout, jcontext = theirs.online_inference(x[:, lo:hi], context=jcontext)
        chunks.append(out[0] if isinstance(out, tuple) else out)
        jchunks.append(jout[0] if isinstance(jout, tuple) else jout)
    streamed = torch.cat(chunks, dim=1)
    _compare(streamed, np.concatenate([np.asarray(c) for c in jchunks], axis=1))
    one_shot = ours(torch.from_numpy(x))
    one_shot = one_shot[0] if isinstance(one_shot, tuple) else one_shot
    # Streaming frames the right edge only when the next chunk arrives, so
    # it yields the first frames of the one-shot pass.
    k = streamed.shape[1]
    assert 0 < k <= one_shot.shape[1]
    torch.testing.assert_close(streamed, one_shot[:, :k], rtol=RTOL, atol=ATOL)


def _jax_arrays(layer):
    arrays = {"_fb": layer._fb}
    fused = layer._fused_matrices()
    if fused is not None:
        arrays["Mc"], arrays["Ms"] = fused[0], fused[1]
    for name in ("_dct", "_lifter"):
        if getattr(layer, name, None) is not None:
            arrays[name] = getattr(layer, name)
    return arrays


@pytest.mark.parametrize("name,kwargs", [
    ("Wav2LogFilterBank", {}), ("Wav2MFCC", {}), ("Wav2LogFilterBank", {"use_energy": True})])
def test_load_numpy_state_keeps_output(name, kwargs):
    x = torch.from_numpy(_audio(12345))
    ours = getattr(tl, name)(**kwargs, device="cpu")
    before = ours(x)
    arrays = _jax_arrays(getattr(jl, name)(**kwargs))
    assert set(arrays) >= {"_fb"}
    load_numpy_state(ours, arrays)
    assert torch.equal(ours(x), before)


def test_load_numpy_state_carries_the_arrays():
    ours = tl.Wav2LogFilterBank(device="cpu")
    arrays = _jax_arrays(jl.Wav2LogFilterBank())
    arrays["_fb"] = arrays["_fb"] * np.float32(2.0)  # a different bank: log-mel shifts by log 2
    x = torch.from_numpy(_audio(16000))
    before = ours(x)
    load_numpy_state(ours, arrays)
    torch.testing.assert_close(ours(x), before + float(np.log(2.0)), rtol=0, atol=1e-5)


def test_load_numpy_state_refuses_mismatch():
    ours = tl.Wav2MFCC(device="cpu")
    arrays = _jax_arrays(jl.Wav2MFCC())
    before = ours._fb.clone()
    with pytest.raises(ValueError, match="shape"):
        load_numpy_state(ours, {**arrays, "_fb": jl.Wav2MFCC(num_filters=40)._fb})
    with pytest.raises(ValueError, match="dtype"):
        load_numpy_state(ours, {**arrays, "_fb": arrays["_fb"].astype(np.float64)})
    with pytest.raises(KeyError, match="_nope"):
        load_numpy_state(ours, {**arrays, "_nope": arrays["_fb"]})
    with pytest.raises(KeyError, match="_lifter"):
        load_numpy_state(tl.Wav2MFCC(cepstral_lifter=0, device="cpu"), {"_lifter": arrays["_lifter"]})
    assert torch.equal(ours._fb, before)  # nothing copied
