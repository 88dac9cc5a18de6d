"""
The port's host→device stages (lhotse_tpu_torch.dataset.loader) on the CPU:
transfer_stream over staged batches (mirroring the JAX package's test in
tests/test_device_pipeline_integration.py), device_prefetch over batch trees,
and the lookahead order of both.
"""
import numpy as np
import pytest
import torch

from lhotse_tpu.dataset.loader import device_prefetch as j_device_prefetch
from lhotse_tpu.dataset.loader import transfer_stream as j_transfer_stream
from lhotse_tpu_torch.dataset.device_augment import CachedBatch, OnDeviceAugmenter
from lhotse_tpu_torch.dataset import loader
from lhotse_tpu_torch.dataset.device_cache import DeviceSampleCache
from lhotse_tpu_torch.dataset.loader import device_prefetch, transfer_stream

SR = 16000


def _staged(aug, n=3):
    audio = (np.random.RandomState(0).randn(2, SR) * 0.1).astype(np.float32)
    return [aug.stage(audio, np.array([SR, SR]), transfer=False) for _ in range(n)]


def test_transfer_stream_moves_staged_audio_and_passes_cached_through():
    """Numpy StagedBatch.audio goes through ``put`` ahead of the consumer;
    items without numpy audio (CachedBatch-like) pass through."""
    aug = OnDeviceAugmenter([(1.0, 2)], gain_range=None, wire_format="int16", device="cpu")
    puts = {"n": 0}

    def fake_put(x):
        puts["n"] += 1
        return torch.from_numpy(x)

    items = []
    for staged in _staged(aug):
        assert isinstance(staged.audio, np.ndarray)  # still host-side
        items.append((staged, 2.0))

    class NoAudio:  # CachedBatch stand-in
        pass

    items.append((NoAudio(), 1.0))
    out = list(transfer_stream(iter(items), lookahead=2, put=fake_put))
    assert len(out) == 4 and puts["n"] == 3
    assert isinstance(out[3][0], NoAudio)
    for staged, asec in out[:3]:
        assert isinstance(staged.audio, torch.Tensor) and asec == 2.0
        feats, flens = aug.compute(staged)
        assert torch.isfinite(feats).all()


def test_transfer_stream_default_put_copies_audio_and_draws():
    aug = OnDeviceAugmenter([(1.0, 2)], wire_format="int16", device="cpu",
                            noise_pool=np.zeros((2, 2 * SR), np.float32))
    staged = _staged(aug, 2)
    wire = [s.audio.copy() for s in staged]
    out = list(transfer_stream(staged, device="cpu"))
    for s, w in zip(out, wire):
        assert isinstance(s.audio, torch.Tensor) and np.array_equal(s.audio.numpy(), w)
        assert s.audio.dtype == torch.int16
        assert all(isinstance(v, torch.Tensor) for v in s.kwargs.values())
    with pytest.raises(ValueError, match="needs a device"):
        transfer_stream(staged)


def test_transfer_stream_leaves_cached_batch_untouched():
    cache = DeviceSampleCache(capacity_seconds=10)
    aug = OnDeviceAugmenter([(1.0, 2)], sample_cache=cache, wire_format="int16", device="cpu")
    audio = (np.random.RandomState(1).randn(2, SR) * 0.1).astype(np.float32)
    aug.compute(aug.stage(audio, [SR, SR], ids=["a", "b"]))
    cached = aug.stage(np.zeros((2, 0), np.float32), [SR, SR], ids=["a", "b"], transfer=False)
    assert isinstance(cached, CachedBatch)
    kwargs = dict(cached.kwargs)
    (out,) = transfer_stream([cached], device="cpu")
    assert out is cached and out.kwargs == kwargs
    assert isinstance(out.kwargs["gains"], np.ndarray)


def test_device_prefetch_trees():
    """Dict batches with numpy, str and int leaves: numpy leaves become
    tensors on the device, the others pass through, as in the JAX package."""
    batches = [{"inputs": np.full((2, 3), i, np.float32), "ids": ["a", "b"], "n": i,
                "nested": {"lens": np.array([3, i])}, "pair": (np.arange(2), "x")}
               for i in range(3)]
    ours = list(device_prefetch(batches, size=2, device="cpu"))
    theirs = list(j_device_prefetch(batches, size=2))
    assert len(ours) == len(theirs) == 3
    for o, t in zip(ours, theirs):
        assert set(o) == set(t)
        assert isinstance(o["inputs"], torch.Tensor)
        assert np.array_equal(o["inputs"].numpy(), np.asarray(t["inputs"]))
        assert np.array_equal(o["nested"]["lens"].numpy(), np.asarray(t["nested"]["lens"]))
        assert isinstance(o["pair"], tuple) and o["pair"][1] == "x"
        assert np.array_equal(o["pair"][0].numpy(), np.asarray(t["pair"][0]))
        assert o["ids"] == t["ids"] and o["n"] == t["n"]
    with pytest.raises(ValueError, match="needs a device"):
        device_prefetch(batches)


@pytest.mark.parametrize("lookahead", [1, 2, 3, 5])
def test_lookahead_order(lookahead, monkeypatch):
    """Both stages yield in input order, and transfer up to ``lookahead``
    items ahead of the consumer (the JAX package's schedule)."""
    events, jevents = [], []

    def source(log):
        for i in range(4):
            log.append(("pull", i))
            yield {"x": np.array([i])}

    def put_into(log):
        def put(x):
            log.append(("put", int(x[0])))
            return x
        return put

    monkeypatch.setattr(loader, "_to_device", lambda x, device: put_into(events)(x))
    got = []
    for item in device_prefetch(source(events), size=lookahead, device="cpu"):
        events.append(("yield", int(item["x"][0])))
        got.append(int(item["x"][0]))

    import jax

    monkeypatch.setattr(jax, "device_put", lambda x, sharding=None: put_into(jevents)(x))
    for item in j_device_prefetch(source(jevents), size=lookahead):
        jevents.append(("yield", int(item["x"][0])))
    assert got == [0, 1, 2, 3]
    assert events == jevents


def test_transfer_stream_schedule_equals_jax():
    log, jlog = [], []

    class Item:
        def __init__(self, i):
            self.audio = np.array([i])
            self.kwargs = {}

    def run(stream, log):
        for item in stream:
            log.append(("yield", int(item.audio[0])))

    def put_into(log):
        def put(x):
            log.append(("put", int(x[0])))
            return x.copy()
        return put

    run(transfer_stream([Item(i) for i in range(4)], lookahead=2, put=put_into(log)), log)
    run(j_transfer_stream([Item(i) for i in range(4)], lookahead=2, put=put_into(jlog)), jlog)
    assert log == jlog
    # Item 2's copy is issued before item 0 reaches the consumer.
    assert log[:4] == [("put", 0), ("put", 1), ("put", 2), ("yield", 0)]
