"""
The port's batch signal transforms (``lhotse_tpu_torch.dataset.
signal_transforms``) against the JAX package's: ``GlobalMVN`` statistics
within 1e-5 (the port's CPU fbank route against the JAX host route on the
same seeded corpus), its apply, inverse and file round trip exactly on the
same statistics; ``RandomizedSmoothing`` bit-exact under a seed, on numpy
arrays and CPU tensors, with its ``state_dict`` resume (either package's
state); ``SpecAugment``'s state round trip and the same draws as JAX's
after a JAX state is loaded; the helpers ``mask_along_axis_optimized``,
``time_warp``, ``schedule_value_for_step`` and
``random_mask_along_batch_axis`` bit-exact; and the batch ``DereverbWPE``
equal to JAX's (both run the same host WPE on each item), held to
``tests/test_torch_wpe.py::test_matches_host_wpe``'s criteria.
"""
import json

import numpy as np
import pytest
import torch

import lhotse_tpu as J
from lhotse_tpu.augmentation.wpe import dereverb_wpe_numpy as jwpe
from lhotse_tpu.dataset import signal_transforms as JS
from lhotse_tpu_torch import CutSet, Fbank, Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.dataset import signal_transforms as PS
from lhotse_tpu_torch.features import FbankConfig
from test_ops_wpe import _reverberant

SR = 16000
STATS_TOL = 1e-5  # the port's CPU fbank route against the JAX host route, through the stats


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five seeded FLAC cuts of 0.5-1.5 s: a tone under white noise."""
    root = tmp_path_factory.mktemp("mvn_corpus")
    rng = np.random.RandomState(33)
    cuts = []
    for i in range(5):
        n = int(SR * rng.uniform(0.5, 1.5))
        wave = np.sin(2 * np.pi * rng.uniform(100, 400) * np.arange(n) / SR) * 0.05
        wave = (wave + rng.randn(n) * 0.1).astype(np.float32)
        path = root / f"c{i}.flac"
        write_flac(str(path), wave, SR)
        cuts.append(Recording.from_file(path).to_cut())
    CutSet.from_cuts(cuts).to_file(root / "cuts.jsonl")
    return root / "cuts.jsonl"


@pytest.fixture(scope="module")
def mvns(corpus):
    ours = PS.GlobalMVN.from_cuts(CutSet.from_jsonl_lazy(corpus),
                                  extractor=Fbank(FbankConfig(device="cpu")))
    theirs = JS.GlobalMVN.from_cuts(J.CutSet.from_jsonl_lazy(corpus), extractor=J.Fbank())
    return ours, theirs


def test_global_mvn_stats_hold_to_jax(mvns):
    ours, theirs = mvns
    assert ours.feature_dim == theirs.feature_dim == 80
    for name in ("norm_means", "norm_stds"):
        got, want = getattr(ours, name), getattr(theirs, name)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=STATS_TOL)


@pytest.mark.parametrize("max_cuts", [1, 3])
def test_global_mvn_max_cuts_holds_to_jax(corpus, max_cuts):
    ours = PS.GlobalMVN.from_cuts(CutSet.from_jsonl_lazy(corpus), max_cuts=max_cuts,
                                  extractor=Fbank(FbankConfig(device="cpu")))
    theirs = JS.GlobalMVN.from_cuts(J.CutSet.from_jsonl_lazy(corpus), max_cuts=max_cuts,
                                    extractor=J.Fbank())
    np.testing.assert_allclose(ours.norm_means, theirs.norm_means, rtol=0, atol=STATS_TOL)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_global_mvn_file_round_trip_across_packages(mvns, tmp_path, writer):
    ours, theirs = mvns
    src, reader = (ours, JS.GlobalMVN) if writer == "port" else (theirs, PS.GlobalMVN)
    src.to_file(tmp_path / "mvn.npz")
    back = reader.from_file(tmp_path / "mvn.npz")
    assert np.array_equal(back.norm_means, src.norm_means)
    assert np.array_equal(back.norm_stds, src.norm_stds)


def test_global_mvn_apply_and_inverse_equal_jax(mvns):
    """On the same statistics the apply is the JAX package's bit for bit,
    on numpy and on CPU tensors; a float64 tensor is normalised in float64."""
    ours, theirs = mvns
    ours = PS.GlobalMVN(80)
    ours.load_state_dict(theirs.state_dict())
    x = np.random.default_rng(5).standard_normal((3, 40, 80)).astype(np.float32) * 4 - 10
    want = theirs(x)
    assert np.array_equal(ours(x), want)
    got = ours(torch.from_numpy(x))
    assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(want))
    assert np.array_equal(ours.inverse(want), theirs.inverse(want))
    assert torch.equal(ours.inverse(torch.from_numpy(want)), torch.from_numpy(theirs.inverse(want)))
    np.testing.assert_allclose(ours.inverse(ours(x)), x, rtol=1e-4, atol=1e-4)
    x64 = torch.from_numpy(x.astype(np.float64))
    assert ours(x64).dtype == torch.float64
    np.testing.assert_allclose(ours(x64).numpy(), want, rtol=0, atol=1e-5)
    assert ours.state_dict()["norm_means"].dtype == np.float32


SMOOTHING = [
    dict(sigma=0.1, p=1.0, seed=0),
    dict(sigma=0.3, sample_sigma=False, p=0.5, seed=1),
    dict(sigma=[(0, 0.01), (2, 0.5), (4, 0.05)], p=0.7, seed=2),
]


@pytest.mark.parametrize("kwargs", SMOOTHING, ids=["constant", "fixed_sigma", "schedule"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_randomized_smoothing_is_bit_exact_to_jax(kwargs, kind):
    rng = np.random.default_rng(9)
    ours, theirs = PS.RandomizedSmoothing(**kwargs), JS.RandomizedSmoothing(**kwargs)
    for step in range(6):
        shape = (4, 800) if step % 2 else (3, 2, 640)
        x = (rng.standard_normal(shape) * 0.6).astype(np.float32)
        want = theirs(x)
        got = ours(torch.from_numpy(x)) if kind == "tensor" else ours(x)
        if kind == "tensor":
            assert got.dtype == torch.float32
            got = got.numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.abs(want).max() <= 1.0
    assert ours.state_dict()["step"] == theirs.state_dict()["step"]


@pytest.mark.parametrize("source", ["port", "jax"])
def test_randomized_smoothing_state_dict_resume(source):
    """Two batches, a state through JSON (from either package), then a
    fresh port transform draws what the first would have."""
    kwargs = dict(sigma=[(0, 0.05), (1, 0.2)], p=0.6, seed=4)
    first = (PS if source == "port" else JS).RandomizedSmoothing(**kwargs)
    x = np.random.default_rng(3).uniform(-0.9, 0.9, (5, 1000)).astype(np.float32)
    first(x)
    first(x)
    state = json.loads(json.dumps(first.state_dict()))
    resumed = PS.RandomizedSmoothing(sigma=kwargs["sigma"], p=0.6, seed=77)
    resumed.load_state_dict(state)
    for _ in range(3):
        assert np.array_equal(resumed(x), first(x))
    assert resumed.state_dict() == first.state_dict()


def test_specaugment_state_round_trip():
    x = np.random.RandomState(1).randn(2, 100, 80).astype(np.float32)
    sa = PS.SpecAugment(seed=3, time_warp_factor=20, frames_mask_size=20)
    sd = json.loads(json.dumps(sa.state_dict()))
    y1 = sa(torch.from_numpy(x))
    sa2 = PS.SpecAugment(seed=99)
    sa2.load_state_dict(sd)
    assert sa2.time_warp_factor == 20 and sa2.frames_mask_size == 20
    y2 = sa2(torch.from_numpy(x))
    assert torch.equal(y1, y2)
    assert sa.state_dict() == sa2.state_dict()


def test_specaugment_loads_jax_state_and_draws_as_jax():
    """A JAX SpecAugment's state after one batch: the port draws the same
    warp maps and masks next, and on numpy batches gives the JAX numpy
    apply's result (the per-example mean's summation order aside)."""
    x = np.random.RandomState(2).randn(3, 120, 80).astype(np.float32)
    theirs = JS.SpecAugment(seed=5, time_warp_factor=30, frames_mask_size=15)
    theirs(x)
    ours = PS.SpecAugment()
    ours.load_state_dict(json.loads(json.dumps(theirs.state_dict())))
    assert ours.state_dict() == theirs.state_dict()
    for a, b in zip(ours.draw_batch(3, 120, 80), theirs.draw_batch(3, 120, 80)):
        assert np.array_equal(a, b)
    got, want = ours(x), theirs(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for a, b in zip(ours._axis_mask_single(80, 10, 3), theirs._axis_mask_single(80, 10, 3)):
        assert a == b


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("mask_size,mask_times", [(10, 2), (1, 4), (30, 1)])
def test_mask_along_axis_optimized_equals_jax(axis, mask_size, mask_times):
    x = np.random.default_rng(0).standard_normal((50, 40)).astype(np.float32)
    got = PS.mask_along_axis_optimized(x, mask_size, mask_times, -5.0, axis,
                                       rng=np.random.default_rng(7))
    want = JS.mask_along_axis_optimized(x, mask_size, mask_times, -5.0, axis,
                                        rng=np.random.default_rng(7))
    assert np.array_equal(got, want) and not np.shares_memory(got, x)
    with pytest.raises(ValueError):
        PS.mask_along_axis_optimized(x, 3, 1, 0.0, 3)


@pytest.mark.parametrize("t,factor,seed", [(100, 10, 0), (100, 10, 1), (30, 20, 2), (500, 80, 3)])
def test_time_warp_equals_jax(t, factor, seed):
    x = np.random.default_rng(seed).standard_normal((t, 20)).astype(np.float32)
    got = PS.time_warp(x, factor, rng=np.random.default_rng(seed))
    want = JS.time_warp(x, factor, rng=np.random.default_rng(seed))
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("step", [0, 1, 4, 5, 1000])
def test_schedule_value_for_step_equals_jax(step):
    schedule = [(0, 0.1), (4, 0.2), (5, 0.3)]
    assert PS.schedule_value_for_step(schedule, step) == JS.schedule_value_for_step(schedule, step)


def test_schedule_value_before_the_first_milestone_asserts_as_jax():
    with pytest.raises(AssertionError):
        JS.schedule_value_for_step([(2, 1.0)], 1)
    with pytest.raises(AssertionError):
        PS.schedule_value_for_step([(2, 1.0)], 1)


@pytest.mark.parametrize("shape,p", [((8, 100), 0.5), ((6, 2, 50), 0.1), ((4,), 0.9)])
def test_random_mask_along_batch_axis_equals_jax(shape, p):
    x = np.zeros(shape, np.float32)
    got = PS.random_mask_along_batch_axis(x, p=p, rng=np.random.default_rng(11))
    want = JS.random_mask_along_batch_axis(x, p=p, rng=np.random.default_rng(11))
    assert got.dtype == np.float32 and got.shape == (shape[0],) + (1,) * (len(shape) - 1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_batch_dereverb_wpe_holds_to_jax(channels, kind):
    items = [_reverberant(channels=channels, seconds=0.5, seed=s) for s in (0, 5)]
    batch = np.stack([a[0] for a in items]) if channels == 1 else np.stack(items)
    want = JS.DereverbWPE()(batch)
    got = PS.DereverbWPE()(torch.from_numpy(batch) if kind == "tensor" else batch)
    if kind == "tensor":
        assert got.dtype == torch.float32
        got = got.numpy()
    assert got.shape == batch.shape and np.array_equal(got, want)
    for item, out in zip(items, got):
        # tests/test_torch_wpe.py::test_matches_host_wpe's criteria: the
        # batch transform runs the host WPE on each item.
        host = jwpe(item).reshape(out.shape)
        assert np.corrcoef(out.ravel(), host.ravel())[0, 1] > 0.95
        assert np.linalg.norm(out - host) / np.linalg.norm(host) < 0.4
        assert float(np.sum(out ** 2)) < 0.5 * float(np.sum(item ** 2))
