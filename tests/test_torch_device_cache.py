"""
The port's DeviceSampleCache (lhotse_tpu_torch.dataset.device_cache) and the
augmenter's cached path on the CPU: the lifecycle of tests/test_device_cache.py,
the ring index and stats against the JAX cache after the same ids, and the
cached features against the JAX package's for the same seed and ids.
"""
import numpy as np
import pytest
import torch

from lhotse_tpu.dataset.device_augment import CachedBatch as JCachedBatch
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.device_cache import DeviceSampleCache as JCache
from lhotse_tpu.dataset.device_cache import batch_cut_info as j_batch_cut_info
from lhotse_tpu_torch.dataset.device_augment import CachedBatch, OnDeviceAugmenter, StagedBatch
from lhotse_tpu_torch.dataset.device_cache import DeviceSampleCache, batch_cut_info
from lhotse_tpu_torch.ops.wire import wire_row_width
from tests.test_torch_device_augment import _JaxKernelRoute

SR = 16000
BUCKETS = [(2.0, 4), (4.0, 3)]
FEATURE_TOL = 1e-4  # the feature parity budget (BASELINE.md)


def _config(cache, seed, **kw):
    noise = (np.random.RandomState(1).randn(2, 5 * SR) * 0.05).astype(np.float32)
    rir = np.zeros(400, np.float32)
    rir[5] = 1.0
    rir[99] = 0.25
    cfg = dict(sampling_rate=SR, speed_factor=1.1, gain_range=(0.9, 1.1), noise_pool=noise,
               snr=(10, 20), mix_prob=1.0, rir=rir, wire_format="int16", seed=seed,
               sample_cache=cache)
    cfg.update(kw)
    return cfg


def make_aug(cache, seed=3, **kw):
    return OnDeviceAugmenter(BUCKETS, device="cpu", **_config(cache, seed, **kw))


def make_jax_aug(cache, seed=3, **kw):
    return JAugmenter(BUCKETS, fbank=_JaxKernelRoute(), **_config(cache, seed, **kw))


def batch(rng, n, dur_s):
    lens = rng.randint(int(0.5 * dur_s * SR), int(dur_s * SR) + 1, size=n)
    audio = np.zeros((n, lens.max()), np.float32)
    for i, l in enumerate(lens):
        audio[i, :l] = rng.randn(l) * 0.1
    return audio, lens.astype(np.int64)


class TestCacheLifecycle:
    def test_miss_then_hit(self):
        cache = DeviceSampleCache(capacity_seconds=60)
        aug = make_aug(cache)
        rng = np.random.RandomState(0)
        audio, lens = batch(rng, 3, 1.9)
        ids = ["a", "b", "c"]

        s1 = aug.stage(audio, lens, ids=ids)
        assert isinstance(s1, StagedBatch) and s1.insert_slots is not None
        aug.compute(s1)  # insert happens here
        assert cache.has_all(ids, s1.bucket_t)

        s2 = aug.stage(audio, lens, ids=ids)
        assert isinstance(s2, CachedBatch)
        assert s2.aug_counter == 1
        assert aug.state_dict(after=s2) == {"seed": 3, "next_counter": 2}
        assert cache.stats()["hit_rate"] > 0

    def test_cached_features_match_wire_path(self):
        """Same draws + same audio: gather path == transfer path on the real
        (non-padding) rows, and the pool holds the exact int16 wire rows."""
        cache = DeviceSampleCache(capacity_seconds=60)
        aug_c = make_aug(cache, seed=7)
        aug_p = make_aug(None, seed=7)
        rng = np.random.RandomState(2)
        audio, lens = batch(rng, 3, 1.8)
        ids = ["x", "y", "z"]

        s1 = aug_c.stage(audio, lens, ids=ids)
        f1c, l1c = aug_c.compute(s1)
        f1p, l1p = aug_p.compute(aug_p.stage(audio, lens))
        assert torch.equal(l1c, l1p)
        torch.testing.assert_close(f1c, f1p, rtol=0, atol=1e-5)
        pool = cache.pool(s1.bucket_t, np.int16)
        assert torch.equal(pool[torch.from_numpy(s1.insert_slots[:3]).long()], s1.audio[:3])

        staged = aug_c.stage(audio, lens, ids=ids)
        assert isinstance(staged, CachedBatch)
        f2c, l2c = aug_c.compute(staged)
        f2p, l2p = aug_p.compute(aug_p.stage(audio, lens))
        assert torch.equal(l2c, l2p)
        real = l2c > 0
        torch.testing.assert_close(f2c[real], f2p[real], rtol=0, atol=1e-5)

    def test_cached_path_with_adpcm4_wire(self):
        """adpcm4 pools hold the NARROW wire rows (headers + packed
        nibbles), not T_b samples."""
        cache = DeviceSampleCache(capacity_seconds=60)
        aug_c = make_aug(cache, seed=11, wire_format="adpcm4")
        aug_p = make_aug(None, seed=11, wire_format="adpcm4")
        rng = np.random.RandomState(5)
        audio, lens = batch(rng, 3, 1.8)
        ids = ["p", "q", "r"]

        aug_c.compute(aug_c.stage(audio, lens, ids=ids))  # fill
        aug_p.compute(aug_p.stage(audio, lens))  # burn the same draws
        staged = aug_c.stage(audio, lens, ids=ids)
        assert isinstance(staged, CachedBatch)
        pool = cache.pool(staged.bucket_t, np.uint8)
        assert pool.dtype == torch.uint8
        assert pool.shape[1] == wire_row_width(staged.bucket_t, "adpcm4")
        f2c, l2c = aug_c.compute(staged)
        f2p, l2p = aug_p.compute(aug_p.stage(audio, lens))
        assert torch.equal(l2c, l2p)
        real = l2c > 0
        torch.testing.assert_close(f2c[real], f2p[real], rtol=0, atol=1e-5)

    def test_ring_eviction_reverts_to_miss(self):
        # Pool sized to ~4 slots for the 2 s bucket.
        cache = DeviceSampleCache(capacity_seconds=2 * 2 * 4.0, min_slots=4)
        aug = make_aug(cache)
        rng = np.random.RandomState(4)
        a1, l1 = batch(rng, 3, 1.5)
        a2, l2 = batch(rng, 3, 1.5)
        aug.compute(aug.stage(a1, l1, ids=["a", "b", "c"]))
        aug.compute(aug.stage(a2, l2, ids=["d", "e", "f"]))  # evicts a..c
        t_b = aug.bucket_shape(a1.shape[1])[0]
        assert not cache.has_all(["a", "b", "c"], t_b)
        assert cache.has_all(["d", "e", "f"], t_b)
        # Evicted ids re-stage as a miss (correctness over residency).
        assert isinstance(aug.stage(a1, l1, ids=["a", "b", "c"]), StagedBatch)

    def test_partial_residency_is_a_miss(self):
        cache = DeviceSampleCache(capacity_seconds=60)
        aug = make_aug(cache)
        rng = np.random.RandomState(5)
        audio, lens = batch(rng, 2, 1.5)
        aug.compute(aug.stage(audio, lens, ids=["p", "q"]))
        a2, len2 = batch(rng, 3, 1.5)
        staged = aug.stage(a2, len2, ids=["p", "q", "NEW"])
        assert isinstance(staged, StagedBatch)
        aug.compute(staged)
        assert cache.has_all(["p", "q", "NEW"], staged.bucket_t)

    def test_other_bucket_is_a_miss(self):
        cache = DeviceSampleCache(capacity_seconds=60)
        aug = make_aug(cache)
        rng = np.random.RandomState(6)
        audio, lens = batch(rng, 2, 1.5)  # 2 s bucket
        aug.compute(aug.stage(audio, lens, ids=["m", "n"]))
        long_audio = np.pad(audio, ((0, 0), (0, 3 * SR - audio.shape[1])))
        long_lens = np.full(2, 3 * SR, np.int64)  # 4 s bucket
        assert isinstance(aug.stage(long_audio, long_lens, ids=["m", "n"]), StagedBatch)

    def test_zero_width_placeholder_without_residency_raises(self):
        cache = DeviceSampleCache(capacity_seconds=60)
        aug = make_aug(cache)
        with pytest.raises(ValueError, match="zero-width"):
            aug.stage(np.zeros((2, 0), np.float32), np.full(2, SR, np.int64),
                      ids=["nope1", "nope2"])

    def test_precompile_warms_both_paths(self):
        cache = DeviceSampleCache(capacity_seconds=120)
        aug = make_aug(cache)
        aug.precompile(group=2)
        assert cache.stats()["misses"] > 0 and cache.stats()["hits"] > 0
        assert aug.state_dict() == {"seed": 3, "next_counter": 0}


def test_placeholder_accepted_when_resident_and_host_staging():
    """A fully resident batch stages from a (B, 0) placeholder; with
    transfer=False a miss batch's numpy audio goes to the device before the
    insert."""
    cache = DeviceSampleCache(capacity_seconds=60)
    aug = make_aug(cache)
    audio, lens = batch(np.random.RandomState(8), 3, 1.7)
    miss = aug.stage(audio, lens, ids=["u", "v", "w"], transfer=False)
    assert isinstance(miss.audio, np.ndarray)
    aug.compute(miss)
    hit = aug.stage(np.zeros((3, 0), np.float32), lens, ids=["u", "v", "w"], transfer=False)
    assert isinstance(hit, CachedBatch) and isinstance(hit.kwargs["gains"], np.ndarray)
    feats, feat_lens = aug.compute(hit)
    assert feats.shape[0] == 4 and torch.isfinite(feats).all()
    assert feat_lens.tolist()[3] == 0


def test_grouped_cached_equals_per_batch():
    cache = DeviceSampleCache(capacity_seconds=60)
    aug = make_aug(cache)
    rng = np.random.RandomState(9)
    data = [batch(rng, 3, 1.6) for _ in range(2)]
    ids = [["a", "b", "c"], ["d", "e", "f"]]
    for (audio, lens), i in zip(data, ids):
        aug.compute(aug.stage(audio, lens, ids=i))
    cached = [aug.stage(audio, lens, ids=i) for (audio, lens), i in zip(data, ids)]
    assert all(isinstance(c, CachedBatch) for c in cached)
    for c, (feats, feat_lens) in zip(cached, aug.compute_grouped(cached)):
        single, single_lens = aug.compute(c)
        assert torch.equal(feat_lens, single_lens) and torch.equal(feats, single)
    assert aug.state_dict(after=cached)["next_counter"] == 4
    misses = [aug.stage(audio, lens, ids=[f"n{k}" for k in range(3)]) for audio, lens in data]
    with pytest.raises(AssertionError, match="compute()"):
        aug.compute_grouped(misses)


def test_cache_serves_one_device():
    cache = DeviceSampleCache()
    make_aug(cache)
    make_aug(cache)  # the same device again is fine
    with pytest.raises(ValueError, match="cannot also serve"):
        cache.configure([2.0], "meta")
    with pytest.raises(ValueError, match="no device"):
        bare = DeviceSampleCache()
        bare.reserve(["a"], SR, 2, SR)
        bare.pool(SR, np.int16)


def test_index_and_stats_equal_jax():
    """The same id sequence (hits, misses, evictions, a second bucket) leaves
    the port's ring index and stats equal to the JAX cache's."""
    ours, theirs = DeviceSampleCache(capacity_seconds=16.0, min_slots=5), JCache(16.0, 5)
    ours.configure([2.0, 4.0], "cpu")
    theirs.configure([2.0, 4.0])
    rng = np.random.default_rng(0)
    for step in range(12):
        t_b = 2 * SR if step % 3 else 4 * SR
        ids = [f"c{k}" for k in rng.integers(0, 9, size=3)]
        ids = list(dict.fromkeys(ids))
        assert ours.has_all(ids, t_b) == theirs.has_all(ids, t_b)
        if ours.has_all(ids, t_b):
            assert np.array_equal(ours.slots(ids, t_b, 4), theirs.slots(ids, t_b, 4))
        else:
            assert np.array_equal(ours.reserve(ids, t_b, 4, SR), theirs.reserve(ids, t_b, 4, SR))
    assert ours._index == theirs._index
    assert ours._owner == theirs._owner
    assert ours._ring == theirs._ring and ours._n_slots == theirs._n_slots
    stats, jstats = ours.stats(), theirs.stats()
    stats.pop("memory_bytes"), jstats.pop("memory_bytes")  # no pools allocated by either
    assert stats == jstats


@pytest.mark.parametrize("wire_format", ["int16", "adpcm4"])
def test_cached_features_match_jax(wire_format):
    """Epoch 1 (miss + insert) and epoch 2 (cached gather) through both
    packages with the same seed and ids: bit-identical draws, equal slots,
    features within the budget on the real rows."""
    cache, jcache = DeviceSampleCache(capacity_seconds=60), JCache(capacity_seconds=60)
    ours = make_aug(cache, seed=5, wire_format=wire_format)
    theirs = make_jax_aug(jcache, seed=5, wire_format=wire_format)
    rng = np.random.RandomState(3)
    data = [batch(rng, 3, 1.8), batch(rng, 2, 3.5)]
    ids = [["a", "b", "c"], ["d", "e"]]
    for epoch in range(2):
        for (audio, lens), i in zip(data, ids):
            s, js = ours.stage(audio, lens, ids=i), theirs.stage(audio, lens, ids=i)
            assert isinstance(s, CachedBatch) == isinstance(js, JCachedBatch) == (epoch == 1)
            assert s.aug_counter == js.aug_counter
            if epoch:
                assert np.array_equal(s.slots, js.slots)
            else:
                assert np.array_equal(s.insert_slots, js.insert_slots)
            for k, v in s.kwargs.items():
                assert np.array_equal(v.cpu().numpy(), np.asarray(js.kwargs[k])), k
            feats, feat_lens = ours.compute(s)
            jfeats, jlens = (np.asarray(a) for a in theirs.compute(js))
            assert np.array_equal(feat_lens.numpy(), jlens)
            real = jlens > 0
            np.testing.assert_allclose(feats.numpy()[real], jfeats[real], rtol=0, atol=FEATURE_TOL)
    assert cache.stats() == {**jcache.stats(), "memory_bytes": cache.memory_bytes()}
    assert cache.memory_bytes() == jcache.memory_bytes()


def test_batch_cut_info_equals_jax():
    class Cut:
        def __init__(self, cut_id, n):
            self.id, self.num_samples = cut_id, n

    cuts = [Cut("a", 100), Cut("a", 100), Cut("b", 250), Cut("c", 7), Cut("b", 250)]
    fake = {"supervisions": {"cut": cuts}}
    ids, lens = batch_cut_info(fake)
    jids, jlens = j_batch_cut_info(fake)
    assert ids == jids == ["a", "b", "c"]
    assert lens.dtype == jlens.dtype and np.array_equal(lens, jlens)
