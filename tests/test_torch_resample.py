"""The port's on-device resampler (lhotse_tpu_torch.ops.resample) against the JAX package's."""
import numpy as np
import pytest
import torch

from lhotse_tpu.augmentation import resample as jhost
from lhotse_tpu.ops import resample as jr
from lhotse_tpu_torch.ops import resample as tr

PAIRS = [(17600, 16000), (14400, 16000), (24000, 16000), (16000, 8000), (8000, 16000),
         (22050, 16000)]


@pytest.mark.parametrize("orig,new", PAIRS)
@pytest.mark.parametrize("method", ["sinc_interp_hann", "sinc_interp_kaiser"])
def test_sinc_kernel_copy_equals_original(orig, new, method):
    ours, w_ours = tr._sinc_resample_kernel(orig, new, resampling_method=method)
    theirs, w_theirs = jhost._sinc_resample_kernel(orig, new, resampling_method=method)
    assert w_ours == w_theirs
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("factor", [0.9, 1.1, 1.5])
def test_speed_perturb_matches_jax(factor):
    x = (0.1 * np.random.default_rng(3).standard_normal((2, 4000))).astype(np.float32)
    ours = tr.speed_perturb(torch.from_numpy(x), factor).numpy()
    theirs = np.asarray(jr.speed_perturb(x, factor))
    assert ours.shape == theirs.shape
    # fp32 sums over the filter taps in another order.
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("orig,new", PAIRS)
def test_sinc_resample_matches_jax_any_leading_shape(orig, new):
    x = (0.1 * np.random.default_rng(orig).standard_normal((2, 1, 3001))).astype(np.float32)
    ours = tr.sinc_resample(torch.from_numpy(x), orig, new).numpy()
    theirs = np.asarray(jr.sinc_resample(x, orig, new))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


def test_same_rate_is_identity():
    x = torch.randn(2, 100)
    assert tr.sinc_resample(x, 16000, 16000) is x


@pytest.mark.parametrize("orig", [17600, 14400, 24000])
def test_resampled_num_samples_matches_jax(orig):
    lens = np.array([0, 1, 159, 16000, 240000, 12345], np.int64)
    for n in lens:
        assert tr.resampled_num_samples(int(n), orig, 16000) == jr.resampled_num_samples(
            int(n), orig, 16000)
    ours = tr.resampled_num_samples(torch.from_numpy(lens), orig, 16000)
    assert np.array_equal(ours.numpy(), jr.resampled_num_samples(lens, orig, 16000))
    # and the length the resampler really produces
    x = torch.zeros(1, 12345)
    assert tr.sinc_resample(x, orig, 16000).shape[-1] == tr.resampled_num_samples(12345, orig, 16000)
