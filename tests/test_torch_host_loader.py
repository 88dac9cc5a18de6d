"""
The port's DataLoader (lhotse_tpu_torch.dataset.loader) against the JAX
package's: the same batch order and ``state_dict()`` with thread prefetch,
thread workers and spawned process workers; worker errors reach the
consumer; spawned workers leave CUDA alone; a mid-epoch resume with
``checkpoint_objects=[augmenter]`` and ``transfer_lookahead`` reproduces
the next batches bit for bit; ``CacheAwareAudioSamples`` returns its
placeholder exactly for resident batches; and the slice as a whole
(manifest → sampler → dataset → loader → OnDeviceAugmenter) gives the JAX
chain's wire arrays and draws, and its features within the 1e-4 budget.
"""
import time

import numpy as np
import pytest
import torch

import lhotse_tpu as J
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.loader import DataLoader as JDataLoader
from lhotse_tpu.dataset.sampling.dynamic_bucketing import (
    DynamicBucketingSampler as JSampler, FixedBucketBatchSizeConstraint as JFixed)
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import CachedBatch, OnDeviceAugmenter, StagedBatch
from lhotse_tpu_torch.dataset.device_cache import (
    CacheAwareAudioSamples, DeviceSampleCache, batch_cut_info)
from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
from lhotse_tpu_torch.dataset.loader import DataLoader
from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
    DynamicBucketingSampler, FixedBucketBatchSizeConstraint)
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.supervision import SupervisionSegment
from test_torch_device_augment import _assert_same_draws, _JaxKernelRoute, _np

SR = 16000
BUCKETS = [(1.0, 3), (2.0, 2)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 FLAC cuts of 0.4-1.9 s, a 0.05 tone under 0.1 white noise,
    written by the port. The noise keeps every mel bin well above float32
    rounding: where a loud tone's leakage nearly cancels in the lowest mel
    bins, two float32 routes (here torch's and XLA's CPU products) part by
    more than the 1e-4 budget (1.1e-4 measured at a 0.3 tone over 0.1
    noise)."""
    root = tmp_path_factory.mktemp("loader_corpus")
    rng = np.random.RandomState(7)
    cuts = []
    for i in range(16):
        n = int(SR * rng.uniform(0.4, 1.9))
        wave = np.sin(2 * np.pi * rng.uniform(100, 400) * np.arange(n) / SR) * 0.05
        wave = (wave + rng.randn(n) * 0.1).astype(np.float32)
        path = root / f"u{i:02d}.flac"
        write_flac(str(path), wave, SR)
        cut = Recording.from_file(path).to_cut()
        cut.supervisions.append(SupervisionSegment(
            id=f"s{i}", recording_id=cut.recording_id, start=0.0, duration=cut.duration, text="x"))
        cuts.append(cut)
    CutSet.from_cuts(cuts).to_file(root / "cuts.jsonl")
    return root / "cuts.jsonl"


def _sampler(corpus, port=True, seed=0):
    cls, fixed, cutset = ((DynamicBucketingSampler, FixedBucketBatchSizeConstraint, CutSet) if port
                          else (JSampler, JFixed, J.CutSet))
    return cls(cutset.from_jsonl_lazy(corpus),
               constraint=fixed(max_seq_len_buckets=[ub for ub, _ in BUCKETS],
                                batch_sizes=[b for _, b in BUCKETS]),
               num_buckets=None, duration_bins=[BUCKETS[0][0]], buffer_size=16, shuffle=True,
               seed=seed, world_size=1, rank=0)


class _IdsDataset:
    """Picklable dataset: the batch's cut ids, and whether CUDA is
    initialised in the process that assembled it."""

    def __getitem__(self, cuts):
        return {"ids": [c.id for c in cuts], "cuda": torch.cuda.is_initialized()}


class _BoomDataset:
    def __getitem__(self, cuts):
        raise ValueError("boom")


MODES = {"thread": dict(prefetch_batches=2), "threads": dict(num_thread_workers=2),
         "spawn": dict(num_workers=2)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_order_and_state_dict_equal_jax(corpus, mode):
    ours = DataLoader(_sampler(corpus), _IdsDataset(), **MODES[mode])
    theirs = JDataLoader(_sampler(corpus, port=False), _IdsDataset(), **MODES[mode])
    serial = [b["ids"] for b in DataLoader(_sampler(corpus), _IdsDataset(), prefetch_batches=0)]
    assert ours.state_dict() == theirs.state_dict()
    got = []
    for a, b in zip(ours, theirs):
        assert a["ids"] == b["ids"]
        assert ours.state_dict() == theirs.state_dict()
        got.append(a["ids"])
    assert len(got) >= 6
    if mode != "spawn":
        # Spawned workers seed the sampler's bucket choice per worker id
        # (dynamic_bucketing.py::_bucket_selection_rng, as in the JAX
        # package), so only the in-process modes keep the serial order.
        assert got == serial


def test_spawned_workers_leave_cuda_alone(corpus):
    batches = list(DataLoader(_sampler(corpus), _IdsDataset(), num_workers=2))
    assert batches and not any(b["cuda"] for b in batches)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_worker_error_reaches_the_consumer(corpus, mode):
    with pytest.raises((ValueError, RuntimeError), match="boom"):
        list(DataLoader(_sampler(corpus), _BoomDataset(), **MODES[mode]))


def _augmenter(cls=OnDeviceAugmenter, specaugment=SpecAugment, **kw):
    noise = (np.random.RandomState(1).randn(2, SR) * 0.05).astype(np.float32)
    rir = (np.random.RandomState(2).randn(800) * np.exp(-np.arange(800) / 100.0)).astype(np.float32)
    rir[0] = 1.0
    return cls(BUCKETS, sampling_rate=SR, speed_factor=1.1, gain_range=(0.8, 1.2), noise_pool=noise,
               snr=(10, 20), mix_prob=1.0, rir=rir, wire_format="int16", seed=0,
               specaugment=specaugment(seed=0), **kw)


def _loader(aug, sampler, dataset_cls=K2SpeechRecognitionDataset, strategy=AudioSamples,
            loader_cls=DataLoader, **kw):
    def stage(batch):
        ns = np.asarray(batch["supervisions"]["num_samples"])
        return aug.stage(np.asarray(batch["inputs"]), ns, transfer=False), ns

    return loader_cls(sampler, dataset_cls(input_strategy=strategy()), prefetch_batches=4,
                      main_apply_fn=stage, transfer_lookahead=2, checkpoint_objects=[aug], **kw)


def test_mid_epoch_resume_is_bit_exact(corpus):
    aug = _augmenter(device="cpu")
    full = []
    for staged, ns in _loader(aug, _sampler(corpus), device="cpu"):
        full.append((ns, *map(_np, aug.compute(staged))))
    assert len(full) >= 6

    # Interrupted: the prefetch thread stages ahead of the 3 consumed batches.
    aug1 = _augmenter(device="cpu")
    loader1 = _loader(aug1, _sampler(corpus), device="cpu")
    it = iter(loader1)
    for _ in range(3):
        staged, _ = next(it)
        aug1.compute(staged)
    time.sleep(0.3)
    ckpt = loader1.state_dict()
    it.close()
    assert aug1._stage_counter > ckpt["objects"][0]["next_counter"] == 3

    aug2 = _augmenter(device="cpu")
    loader2 = _loader(aug2, _sampler(corpus), device="cpu")
    loader2.load_state_dict(ckpt)
    resumed = [(ns, *map(_np, aug2.compute(staged))) for staged, ns in loader2]
    assert len(resumed) == len(full) - 3
    for (n_a, f_a, l_a), (n_b, f_b, l_b) in zip(full[3:], resumed):
        assert np.array_equal(n_a, n_b) and np.array_equal(l_a, l_b) and np.array_equal(f_a, f_b)


def test_transfer_lookahead_needs_a_device(corpus):
    with pytest.raises(ValueError, match="device"):
        _loader(_augmenter(device="cpu"), _sampler(corpus))


def test_cache_aware_placeholder_exactly_when_resident(corpus):
    cache = DeviceSampleCache(capacity_seconds=600)
    aug = _augmenter(device="cpu", sample_cache=cache)
    strategy = CacheAwareAudioSamples(aug)
    dataset = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=strategy)
    batches = list(_sampler(corpus))
    for epoch in range(2):
        for cuts in batches:
            batch = dataset[cuts]
            ids, lens = batch_cut_info(batch)
            assert (batch["inputs"].shape[1] == 0) == (epoch == 1)
            staged = aug.stage(batch["inputs"], lens, ids=ids)
            assert isinstance(staged, CachedBatch if epoch else StagedBatch)
            aug.compute(staged)
    # A batch with one cut that is not resident decodes in full.
    first, second = batches[0], batches[1]
    mixed = CutSet.from_cuts(list(first)[:-1] + [list(second)[0].with_id("unseen")])
    audio, lens = strategy(mixed)
    assert audio.shape[1] == lens.max() > 0


def test_slice_matches_jax(corpus):
    ours_aug = _augmenter(device="cpu")
    jax_aug = _augmenter(JAugmenter, JSpecAugment, fbank=_JaxKernelRoute())
    ours = _loader(ours_aug, _sampler(corpus), device="cpu")
    theirs = _loader(jax_aug, _sampler(corpus, port=False), dataset_cls=JDataset,
                     strategy=JAudioSamples, loader_cls=JDataLoader)
    n = 0
    for (s_ours, ns_ours), (s_jax, ns_jax) in zip(ours, theirs):
        assert np.array_equal(ns_ours, ns_jax)
        _assert_same_draws(s_ours, s_jax)
        assert np.array_equal(_np(s_ours.audio), np.asarray(s_jax.audio))  # wire bytes
        feats, lens = ours_aug.compute(s_ours)
        jfeats, jlens = jax_aug.compute(s_jax)
        assert np.array_equal(_np(lens), np.asarray(jlens))
        np.testing.assert_allclose(_np(feats), np.asarray(jfeats), rtol=0, atol=1e-4)
        assert ours.state_dict() == theirs.state_dict()
        n += 1
    assert n >= 6


def test_resume_with_apply_fn_staging_is_bit_exact(corpus):
    """``apply_fn`` stages and computes in the prefetching producer, so the
    yielded batch carries no ``aug_counter``: the loader publishes the
    augmenter's state the producer snapshotted right after that batch, not
    its live state, which has run ahead (the JAX loader takes the live
    state there and shifts the augmentation stream on resume)."""

    def make(aug):
        def stage_and_compute(batch):
            ns = np.asarray(batch["supervisions"]["num_samples"])
            return aug.compute(aug.stage(np.asarray(batch["inputs"]), ns))

        return DataLoader(_sampler(corpus), K2SpeechRecognitionDataset(input_strategy=AudioSamples()),
                          prefetch_batches=2, apply_fn=stage_and_compute, checkpoint_objects=[aug])

    full = list(make(_augmenter(device="cpu")))
    assert len(full) >= 6
    aug1 = _augmenter(device="cpu")
    loader1 = make(aug1)
    it = iter(loader1)
    for _ in range(3):
        time.sleep(0.3)  # the producer stages ahead of the consumer
        next(it)
    ckpt = loader1.state_dict()
    it.close()
    assert aug1._stage_counter > ckpt["objects"][0]["next_counter"] == 3

    loader2 = make(_augmenter(device="cpu"))
    loader2.load_state_dict(ckpt)
    resumed = list(loader2)
    assert len(resumed) == len(full) - 3
    for (f_a, l_a), (f_b, l_b) in zip(full[3:], resumed):
        assert torch.equal(l_a, l_b) and torch.equal(f_a, f_b)


class _Float64Torch:
    """``torch`` for the port's chain modules with ``float32`` read as
    ``float64``: the same stages, in float64."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


class _Float64Fbank:
    """The fbank kernel's function (edge pad, the folded DFT products, power,
    mel, floored log) in float64, on the layer's float32 matrices."""

    frame_shift = 0.01

    def __init__(self):
        from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank

        Mc, Ms, fb, _ = Wav2LogFilterBank(device="cpu")._fused_matrices()
        self.mats = [torch.as_tensor(m).double() for m in (Mc, Ms, fb)]

    def __call__(self, x):
        from lhotse_tpu_torch.ops import fbank_cuda
        from lhotse_tpu_torch.ops.fbank import FLT_EPS

        frames = fbank_cuda.edge_pad(x.double()).unfold(-1, 400, 160)
        Mc, Ms, fb = self.mats
        power = (frames @ Mc) ** 2 + (frames @ Ms) ** 2
        return torch.log(torch.clamp_min(power @ fb, FLT_EPS))


def test_chain_on_tone_bursts_holds_to_float64():
    """bench.py::_synthesize_corpus's tone bursts (four harmonics of an
    80-220 Hz f0 at 0.2, over a 0.01 white-noise floor) through the e2e
    augmenter (speed 1.1, gain, noise at 10-20 dB, a 0.5 s RIR): the port's
    CPU chain, the JAX chain (its fbank layer's kernel route in XLA) and the
    same stages in float64. Before the CPU route took its DFT products in
    float64 the port was the farther one, 1.07e-4 from float64 where JAX is
    5.7e-5, all of it in the fbank stage's float32 GEMMs (7.9e-5 vs XLA's
    3.3e-5 on the same input; the audio stages are within 3e-7 of float64
    in both). Measured now: 4.65e-5, the audio stages' float32 rounding
    amplified in the lowest mel bins."""
    from lhotse_tpu_torch.ops import augment, resample

    rng = np.random.RandomState(1234)

    def tone_burst(n):
        t = np.arange(n) / SR
        f0 = rng.uniform(80, 220)
        wave = sum(np.sin(2 * np.pi * f0 * (h + 1) * t) / (h + 1) for h in range(4)) * 0.2
        return (wave + rng.randn(n) * 0.01).astype(np.float32)

    lens = np.array([int(SR * rng.uniform(1.5, 3.0)) for _ in range(8)])
    lens[0] = 3 * SR
    audio = np.zeros((8, 3 * SR), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = tone_burst(n)
    rng_init = np.random.RandomState(99)
    L = SR // 2
    rir = (np.exp(-np.arange(L) / (L / 6.0)) * rng_init.randn(L) * 0.5).astype(np.float32)
    rir[L // 50] = 1.0
    cfg = dict(sampling_rate=SR, speed_factor=1.1, gain_range=(0.8, 1.2),
               noise_pool=(rng_init.randn(4, 10 * SR) * 0.05).astype(np.float32), snr=(10, 20),
               mix_prob=1.0, rir=rir, wire_format="int16", seed=0)
    buckets = [(3.0, 8)]

    ours = OnDeviceAugmenter(buckets, device="cpu", **cfg)
    staged = ours.stage(audio, lens)
    feats, feat_lens = ours.compute(staged)
    theirs = JAugmenter(buckets, fbank=_JaxKernelRoute(), **cfg)
    jfeats, _ = theirs.compute(theirs.stage(audio, lens))

    conv_weight = resample._conv_weight
    saved = augment.torch, resample.torch, resample._conv_weight
    augment.torch = resample.torch = _Float64Torch()
    resample._conv_weight = lambda *a: conv_weight(*a).double()
    try:
        truth, _ = OnDeviceAugmenter(buckets, device="cpu", fbank=_Float64Fbank(), **cfg).compute(staged)
    finally:
        augment.torch, resample.torch, resample._conv_weight = saved
    assert truth.dtype == torch.float64
    real = np.arange(truth.shape[1])[None, :] < _np(feat_lens)[:, None]
    port_err = np.abs(_np(feats) - _np(truth))[real].max()
    jax_err = np.abs(np.asarray(jfeats) - _np(truth))[real].max()
    assert port_err <= jax_err and port_err <= 5e-5, (port_err, jax_err)
