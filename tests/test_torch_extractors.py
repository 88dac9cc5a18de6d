"""
The port's extractors (lhotse_tpu_torch.features.kaldi.extractors) on the
CPU against the JAX package's device route, which ``device="tpu"`` runs on
JAX's CPU backend as XLA ops (as tests/test_extractor_paths_randomized.py
does): the same seeded items through ``extract`` and ``extract_batch``.
"""
import numpy as np
import pytest
import torch

from lhotse_tpu.features.kaldi import extractors as J
from lhotse_tpu.utils import compute_num_frames_from_samples as j_num_frames_from_samples
from lhotse_tpu_torch.features.kaldi import extractors as P
from lhotse_tpu_torch.ops import fbank_cuda
from lhotse_tpu_torch.utils import compute_num_frames_from_samples

pytestmark = pytest.mark.filterwarnings("ignore:.*snip_edges")

SR = 16000
# Max-abs tolerances, no looser than tests/test_extractor_paths_randomized.py's
# TOL (fbank 6e-4, mfcc 1.5e-3, logspec 2e-2), with the maxima measured over
# every case of this file beside them. Both sides are folded-GEMM float32
# math; what remains is summation order in near-silent bins of the tonal
# items (largest on the GEMM route, 1.2e-5 on the kernel route's). The
# spectrogram is compared relative to its largest value, the log-spectrogram
# on bins within 20 nats of its peak (below that a log power is rounding
# noise in both).
TOL = {
    "Fbank": 3e-4,  # measured 1.6e-04 (400-point FFT, GEMM route)
    "Mfcc": 1e-4,  # measured 2.9e-05
    "Spectrogram": 1e-5,  # relative to the max; measured 4.3e-06
    "LogSpectrogram": 5e-3,  # measured 1.4e-03
}
KINDS = sorted(TOL)
LENGTHS = [16000, 12345, 401, 8000, 3000]


def _items():
    rng = np.random.default_rng(0)
    out = []
    for n in LENGTHS:
        t = np.arange(n) / SR
        out.append((0.3 * np.sin(2 * np.pi * (110 + n % 300) * t)
                    + 0.05 * rng.standard_normal(n)).astype(np.float32))
    return out


def _pair(kind, **cfg):
    jcfg = getattr(J, f"{kind}Config")(device="tpu", **cfg)
    pcfg = getattr(P, f"{kind}Config")(device="cpu", **cfg)
    return getattr(J, kind)(jcfg), getattr(P, kind)(pcfg)


def _err(kind, a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    diff = np.abs(a - b)
    if kind == "Spectrogram":
        return diff.max() / np.abs(a).max()
    if kind == "LogSpectrogram":
        ref = np.maximum(a, b)
        return diff[ref > ref.max() - 20.0].max()
    return diff.max()


CONFIGS = {
    "default": {},
    "energy": {"use_energy": True},
    "hanning": {"window_type": "hanning"},
    "snip_edges": {"snip_edges": True},
    "fft400": {"round_to_power_of_two": False},
    "fft_mag": {"use_fft_mag": True},
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", KINDS)
def test_extract_batch_matches_jax(kind, config):
    theirs, ours = _pair(kind, **CONFIGS[config])
    items = _items()
    a, b = theirs.extract_batch(items, SR), ours.extract_batch(items, SR)
    assert len(a) == len(b) == len(items)
    for x, y, item in zip(a, b, items):
        assert y.dtype == np.float32
        assert y.shape[0] == ours._num_frames(len(item))
        # The JAX device route gives a snip_edges=True item more frames (see
        # test_snip_edges_frame_counts_are_the_host_routes); the rest agree.
        assert x.shape == y.shape or CONFIGS[config].get("snip_edges")
        if y.size:
            assert _err(kind, x[: len(y)], y) <= TOL[kind], (kind, config)


@pytest.mark.parametrize("kind", KINDS)
def test_extract_matches_jax(kind):
    theirs, ours = _pair(kind)
    items = _items()
    for x in (items[0], np.stack([items[1][:8000], items[3]])):
        a, b = theirs.extract(x, SR), ours.extract(x, SR)
        assert a.shape == b.shape
        assert _err(kind, a, b) <= TOL[kind]


def test_single_item_batch_shapes_equal_jax():
    theirs, ours = _pair("Fbank")
    item = _items()[1]
    for arg in ([item], item):
        a, b = theirs.extract_batch(arg, SR), ours.extract_batch(arg, SR)
        assert type(a) is type(b)
        assert np.asarray(a).shape == np.asarray(b).shape


def test_extract_batch_with_lengths():
    theirs, ours = _pair("Mfcc")
    items = _items()[:3]
    padded = np.zeros((3, 16000), np.float32)
    for i, x in enumerate(items):
        padded[i, : len(x)] = x
    lengths = np.array([len(x) for x in items])
    for x, y in zip(theirs.extract_batch(padded, SR, lengths=lengths),
                    ours.extract_batch(padded, SR, lengths=lengths)):
        assert x.shape == y.shape and _err("Mfcc", x, y) <= TOL["Mfcc"]


@pytest.mark.parametrize("kind", ["Fbank", "Mfcc"])
def test_snip_edges_frame_counts_are_the_host_routes(kind):
    """With snip_edges=True each item gets _num_frames(n) frames: 75 for
    12,345 samples, as the JAX package's host route gives, where its device
    route gives 77 (frames that overlap the zero padding)."""
    x = _items()[0]
    ours = getattr(P, kind)(getattr(P, f"{kind}Config")(snip_edges=True, device="cpu"))
    host = getattr(J, kind)(getattr(J, f"{kind}Config")(snip_edges=True, device="cpu"))
    device_route = getattr(J, kind)(getattr(J, f"{kind}Config")(snip_edges=True, device="tpu"))
    got = ours.extract_batch([x, x[:12345]], SR)
    want = host.extract_batch([x, x[:12345]], SR)
    assert [g.shape[0] for g in got] == [w.shape[0] for w in want] == [98, 75]
    assert [f.shape[0] for f in device_route.extract_batch([x, x[:12345]], SR)] == [98, 77]
    np.testing.assert_allclose(got[1], ours.extract(x[:12345], SR), rtol=0, atol=TOL[kind])


@pytest.mark.parametrize("config,kernel", [
    ({}, True), ({"use_energy": True}, False), ({"use_fft_mag": True}, False),
    ({"frame_shift": 0.0125}, False), ({"round_to_power_of_two": False}, False),
    ({"high_freq": 0.0}, True)])
@pytest.mark.parametrize("kind", ["Fbank", "Mfcc"])
def test_kernel_route_conditions(kind, config, kernel, monkeypatch):
    """Fbank and Mfcc go through the fused fbank wrapper exactly when the
    JAX package's _pallas_matrices would take its kernel."""
    calls = []
    real = fbank_cuda.fbank_fused_padded

    def spy(*args, **kwargs):
        calls.append(kwargs["snip_edges"])
        return real(*args, **kwargs)

    monkeypatch.setattr(fbank_cuda, "fbank_fused_padded", spy)
    theirs, ours = _pair(kind, **config)
    jax_kernel = (theirs._pallas_matrices() is not None if kind == "Fbank"
                  else theirs.extractor._fused_matrices() is not None)
    assert jax_kernel == kernel
    a, b = theirs.extract_batch(_items(), SR), ours.extract_batch(_items(), SR)
    assert calls == ([True] if kernel else [])
    for x, y in zip(a, b):
        assert x.shape == y.shape and _err(kind, x, y) <= TOL[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_every_extraction_method_checks_the_sampling_rate(kind):
    ours = getattr(P, kind)(getattr(P, f"{kind}Config")(device="cpu"))
    x = _items()[0]
    for call in (lambda: ours.extract(x, 8000), lambda: ours.extract_batch([x], 8000),
                 lambda: ours.extract_batch_collated([x], 8000)):
        with pytest.raises(ValueError, match="sampling_rate"):
            call()
    assert ours.extract_batch_collated([x], SR) is None
    assert getattr(J, kind)(getattr(J, f"{kind}Config")(device="tpu")).extract_batch_collated(
        [x], SR) is None


@pytest.mark.parametrize("kind", KINDS)
def test_config_dicts_and_dims_equal_jax(kind):
    over = {"Fbank": {"num_mel_bins": 40}, "Mfcc": {"num_ceps": 20}}.get(kind, {})
    jcfg = getattr(J, f"{kind}Config")(**over)
    pcfg = getattr(P, f"{kind}Config")(**over)
    # The port runs on the card unless asked for the CPU; the JAX package's
    # extractors default to its host route.
    assert pcfg.device == "cuda" and jcfg.device == "cpu"
    assert pcfg.to_dict() == {**jcfg.to_dict(), "device": "cuda"}
    assert list(pcfg.to_dict()) == list(jcfg.to_dict())
    assert type(pcfg).from_dict(pcfg.to_dict()) == pcfg
    theirs, ours = getattr(J, kind)(jcfg), getattr(P, kind)(pcfg)
    assert ours.feature_dim(SR) == theirs.feature_dim(SR)
    assert ours.frame_shift == theirs.frame_shift and ours.name == theirs.name
    ours.to("cpu")
    assert ours.config.device == "cpu"


@pytest.mark.parametrize("kind", ["Fbank", "Spectrogram", "LogSpectrogram"])
def test_mix_energy_and_scale_equal_jax(kind):
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((20, 8)).astype(np.float32) for _ in range(2))
    if kind == "Spectrogram":
        a, b = np.abs(a), np.abs(b)
    jcls, pcls = getattr(J, kind), getattr(P, kind)
    assert np.array_equal(pcls.mix(a, b, 0.3), jcls.mix(a, b, 0.3))
    assert pcls.compute_energy(a) == jcls.compute_energy(a)
    assert np.array_equal(pcls.scale(a, 0.7), jcls.scale(a, 0.7))


@pytest.mark.parametrize("n", [0, 1, 79, 80, 81, 159, 160, 12345, 16000])
def test_num_frames_from_samples_equals_jax(n):
    for shift in (0.01, 0.0125):
        assert compute_num_frames_from_samples(n, shift, SR) == j_num_frames_from_samples(
            n, shift, SR)


def test_dither_is_drawn_on_the_host():
    """dither != 0 draws from the ambient numpy RNG as in the JAX package;
    the layer underneath never dithers (it would need a torch.Generator)."""
    x = _items()[0]
    ours = P.Fbank(P.FbankConfig(dither=0.1, device="cpu"))
    assert ours.extractor.dither == 0.0
    np.random.seed(3)
    a = ours.extract(x, SR)
    np.random.seed(3)
    b = ours.extract(x, SR)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, P.Fbank(P.FbankConfig(device="cpu")).extract(x, SR))
    np.random.seed(3)
    jax_dithered = J.Fbank(J.FbankConfig(dither=0.1, device="tpu")).extract(x, SR)
    assert _err("Fbank", jax_dithered, a) <= TOL["Fbank"]


def test_result_is_on_the_host_and_layer_follows_the_device():
    ours = P.Fbank(P.FbankConfig(device="cpu"))
    out = ours.extract(_items()[0], SR)
    assert isinstance(out, np.ndarray)
    assert ours.extractor.device == torch.device("cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_configs_default_to_the_card(kind):
    """Every extractor runs on the card unless the caller asks for the CPU:
    with no card, the default extractor raises instead of running here."""
    cfg = getattr(P, f"{kind}Config")()
    assert cfg.device == "cuda"
    assert type(cfg).from_dict(cfg.to_dict()).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        getattr(P, kind)().extract(_items()[0], SR)
