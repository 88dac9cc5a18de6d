"""
The port's OnDeviceAugmenter (lhotse_tpu_torch.dataset.device_augment)
against the JAX package's, on the CPU: bit-identical draws, features within
the 1e-4 budget, and checkpoints that resume across and within the packages.
"""
import numpy as np
import pytest
import torch

from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter, StagedBatch
from lhotse_tpu_torch.dataset.device_cache import DeviceSampleCache
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment

SR = 16000
BUCKETS = [(1.0, 4), (2.0, 3)]
DRAWS = ("gains", "snr", "mix_mask", "warp_src", "time_mask", "freq_mask", "noise")


def _rir():
    rng = np.random.default_rng(1)
    rir = (rng.standard_normal(800) * np.exp(-np.arange(800) / 100.0)).astype(np.float32)
    rir[5] = 1.0
    return rir


def _config(**over):
    noise = (0.05 * np.random.default_rng(2).standard_normal((5, 40000))).astype(np.float32)
    cfg = dict(speed_factor=1.1, noise_pool=noise, rir=_rir(), snr=(10, 20), mix_prob=0.5,
               seed=3)
    cfg.update(over)
    return cfg


def _port(wire_format="float32", **over):
    return OnDeviceAugmenter(BUCKETS, wire_format=wire_format,
                             specaugment=SpecAugment(seed=7), device="cpu", **_config(**over))


class _JaxKernelRoute:
    """The default JAX fbank layer's kernel route (its TPU computation) in
    the JAX package's XLA ops; on the CPU the JAX layer takes another
    float32 route, up to 2.4e-4 from float64 in near-silent low mel bins
    (tests/test_torch_layers.py), while the port takes the kernel route on
    every device."""

    frame_shift = 0.01
    num_filters = 80

    def __init__(self):
        from lhotse_tpu.features.kaldi.layers import Wav2LogFilterBank

        self.Mc, self.Ms, self.fb, _ = Wav2LogFilterBank()._fused_matrices()

    def __call__(self, x):
        from lhotse_tpu.ops import fbank as jops

        frames = jops.frame_signal(x, 400, 160, snip_edges=False)
        return jops.mel_fbank_from_power(jops.power_spectrum_gemm(frames, self.Mc, self.Ms), self.fb)


def _jax(wire_format="float32", **over):
    return JAugmenter(BUCKETS, wire_format=wire_format, specaugment=JSpecAugment(seed=7),
                      fbank=_JaxKernelRoute(), **_config(**over))


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for b, t, lens in [(3, 12000, [12000, 9000, 11000]), (2, 30000, [30000, 20000]),
                       (4, 16000, [16000, 16000, 5000, 800])]:
        out.append(((0.1 * rng.standard_normal((b, t))).astype(np.float32), np.array(lens)))
    return out


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_draws(ours: StagedBatch, theirs) -> None:
    assert ours.aug_counter == theirs.aug_counter
    assert ours.bucket_t == theirs.bucket_t
    assert np.array_equal(ours.lens, theirs.lens)
    assert set(ours.kwargs) == set(theirs.kwargs) == set(DRAWS)
    for k in DRAWS:
        a, b = _np(ours.kwargs[k]), _np(theirs.kwargs[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("wire_format", ["int16", "float32", "adpcm4"])
def test_draws_and_features_match_jax(wire_format):
    ours, theirs = _port(wire_format), _jax(wire_format)
    for audio, lens in _batches():
        s_ours, s_theirs = ours.stage(audio, lens), theirs.stage(audio, lens)
        _assert_same_draws(s_ours, s_theirs)
        assert np.array_equal(_np(s_ours.audio), np.asarray(s_theirs.audio))  # wire bytes
        feats, feat_lens = ours.compute(s_ours)
        jfeats, jlens = theirs.compute(s_theirs)
        assert tuple(feats.shape) == np.asarray(jfeats).shape
        assert np.array_equal(_np(feat_lens), np.asarray(jlens))
        # The feature parity budget (BASELINE.md).
        np.testing.assert_allclose(_np(feats), np.asarray(jfeats), rtol=0, atol=1e-4)


def test_oversize_batch_raises():
    with pytest.raises(ValueError, match="exceeds the covering bucket"):
        _port().stage(np.zeros((5, 8000), np.float32), [8000] * 5)


def test_bucket_shape_and_int16_input():
    aug = _port(gain_range=None, noise_pool=None, rir=None, speed_factor=None)
    assert aug.bucket_shape(SR // 2) == (SR, 4)
    assert aug.bucket_shape(SR + 1) == (2 * SR, 3)
    assert aug.bucket_shape(5 * SR) == (2 * SR, 3)
    x = (0.1 * np.random.default_rng(0).standard_normal((2, 8000))).astype(np.float32)
    as_int16 = (x * 32768).astype(np.int16)
    a, _ = _port(noise_pool=None)(as_int16, [8000, 8000])
    b, _ = _port(noise_pool=None)(as_int16.astype(np.float32) / 32768.0, [8000, 8000])
    assert torch.equal(a, b)


def test_compute_grouped_equals_per_batch():
    aug = _port()
    rng = np.random.default_rng(8)
    staged = [aug.stage((0.1 * rng.standard_normal((4, 16000))).astype(np.float32),
                        [16000, 12000, 9000, 16000]) for _ in range(3)]
    grouped = aug.compute_grouped(staged)
    assert len(grouped) == 3
    for s, (feats, feat_lens) in zip(staged, grouped):
        single, single_lens = aug.compute(s)
        # Bit-identical, as in the JAX package: the port runs each batch of
        # the group on its own.
        assert torch.equal(feat_lens, single_lens) and torch.equal(feats, single)
    assert aug.state_dict(after=staged)["next_counter"] == 3
    # Host-side (transfer=False) batches group too.
    host = [aug.stage(np.zeros((4, 16000), np.float32), [16000] * 4, transfer=False)
            for _ in range(2)]
    assert isinstance(host[0].audio, np.ndarray)
    assert len(aug.compute_grouped(host)) == 2


def test_resume_within_port_is_bit_exact():
    a = _port("int16")
    staged = [a.stage(audio, lens) for audio, lens in _batches()]
    outs = [a.compute(s) for s in staged]
    ckpt = a.state_dict(after=staged[0])
    assert ckpt == {"seed": 3, "next_counter": 1}
    b = _port("int16")
    b.load_state_dict(ckpt)
    for (audio, lens), s, (feats, feat_lens) in zip(_batches()[1:], staged[1:], outs[1:]):
        again = b.stage(audio, lens)
        assert again.aug_counter == s.aug_counter
        for k in DRAWS:
            assert torch.equal(again.kwargs[k], s.kwargs[k]), k
        f2, l2 = b.compute(again)
        assert torch.equal(f2, feats) and torch.equal(l2, feat_lens)


def test_jax_checkpoint_resumes_in_port():
    jax_aug = _jax("int16")
    batches = _batches()
    for audio, lens in batches[:2]:
        jax_aug.stage(audio, lens)
    ckpt = jax_aug.state_dict()
    port = _port("int16")
    port.load_state_dict(ckpt)
    _assert_same_draws(port.stage(*batches[2]), jax_aug.stage(*batches[2]))


def test_precompile_is_rng_neutral_and_load_state_checks():
    aug = _port()
    aug.stage(np.zeros((2, 8000), np.float32), [8000, 8000])
    before = aug.state_dict()
    aug.precompile(group=2)
    assert aug.state_dict() == before == {"seed": 3, "next_counter": 1}
    with pytest.raises(ValueError, match="seed"):
        aug.load_state_dict({"seed": 4, "next_counter": 0})
    with pytest.raises(ValueError, match="sequential"):
        aug.load_state_dict({"seed": 3, "rng_state": {}})
    with pytest.raises(ValueError, match="aug_counter"):
        aug.state_dict(after=object())


def test_cache_and_adpcm4_accepted_unknown_format_raises():
    cache = DeviceSampleCache()
    aug = OnDeviceAugmenter(BUCKETS, sample_cache=cache, wire_format="adpcm4", device="cpu")
    assert aug.sample_cache is cache and cache.device == torch.device("cpu")
    with pytest.raises(ValueError, match="T % 64 == 0"):
        OnDeviceAugmenter([(1.001, 2)], wire_format="adpcm4", device="cpu")
    with pytest.raises(ValueError, match="Unknown wire format"):
        OnDeviceAugmenter(BUCKETS, wire_format="opus", device="cpu")
