"""
The port's multiplexers (``lhotse_tpu_torch.lazy.LazyIteratorMultiplexer``,
``LazyInfiniteApproximateMultiplexer``, ``CutSet.mux``/``infinite_mux``) and
``DataloaderCheckpoint`` against the JAX package, on the cases of
``tests/test_lazy_runtime.py``, ``tests/test_e2e_checkpoint_sweep.py::
test_mux_pipeline_sweep`` and ``tests/test_checkpoint_api.py::
test_dataloader_checkpoint_json_roundtrip``: the same ids in the same order
for a full pass and for one resumed from a pickled ``state_dict`` or a
JSON checkpoint file (either package's), the infinite mux refusing a
checkpoint and a loader over it resuming by replay (or refusing, where its
sampler keeps no state) as JAX's does, and the slice as a whole: two seeded corpora
through mux → ``DynamicBucketingSampler`` → ``OnTheFlyFeatures`` →
``GlobalMVN``, the same cut ids batch by batch and the features within the
1e-4 budget (BASELINE.md) of the JAX layer's kernel route computed with its
XLA ops (ROADMAP's like-for-like rule), normalised by the JAX
``GlobalMVN``.
"""
import json
import pickle
import time
import warnings

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu import checkpoint as jckpt
from lhotse_tpu import lazy as jlazy
from lhotse_tpu.dataset import DataLoader as JDataLoader
from lhotse_tpu.dataset import GlobalMVN as JGlobalMVN
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.dataset.sampling.dynamic import DynamicCutSampler as JDynamicCutSampler
from lhotse_tpu.dataset.sampling.dynamic_bucketing import DynamicBucketingSampler as JBucketing
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi import layers as jl
from lhotse_tpu.testing.dummies import DummyManifest as JDummy
from lhotse_tpu_torch import CutSet, Fbank, Recording, SupervisionSegment
from lhotse_tpu_torch import checkpoint as pckpt
from lhotse_tpu_torch import lazy as plazy
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.dataset import (
    DataLoader, DynamicBucketingSampler, DynamicCutSampler, GlobalMVN,
    K2SpeechRecognitionDataset, OnTheFlyFeatures, SpecAugment)
from lhotse_tpu_torch.features import FbankConfig
from lhotse_tpu_torch.indexing import create_jsonl_index
from lhotse_tpu_torch.testing.dummies import DummyManifest
from test_torch_layers import _jax_fused_route

SR = 16000
FEATURE_TOL = 1e-4  # the feature budget (BASELINE.md), against the JAX kernel route in XLA


def ids(iterable):
    return [c.id for c in iterable]


def _dummies(begin, end):
    return DummyManifest(CutSet, begin_id=begin, end_id=end), JDummy(J.CutSet, begin_id=begin,
                                                                       end_id=end)


def _lazy_pair(tmp_path, begin, end, name):
    """The same dummy cuts written once, opened lazily by each package."""
    path = tmp_path / f"{name}.jsonl.gz"
    DummyManifest(CutSet, begin_id=begin, end_id=end).to_file(path)
    return CutSet.from_jsonl_lazy(path), J.CutSet.from_jsonl_lazy(path)


@pytest.mark.parametrize("seed", [0, 7, 8, 12345])
def test_multiplexer_order_equals_jax(seed):
    (a, ja), (b, jb) = _dummies(0, 5), _dummies(100, 105)
    first = ids(plazy.LazyIteratorMultiplexer(a, b, seed=seed))
    assert first == ids(jlazy.LazyIteratorMultiplexer(ja, jb, seed=seed))
    assert sorted(first) == sorted(ids(a) + ids(b))
    assert ids(plazy.LazyIteratorMultiplexer(a, b, seed=seed)) == first


def test_multiplexer_seed_changes_the_order():
    (a, _), (b, _) = _dummies(0, 5), _dummies(100, 105)
    assert ids(plazy.LazyIteratorMultiplexer(a, b, seed=7)) != ids(
        plazy.LazyIteratorMultiplexer(a, b, seed=8))


def test_multiplexer_weights_equal_jax():
    (a, ja), (b, jb) = _dummies(0, 50), _dummies(100, 150)
    ours = ids(plazy.LazyIteratorMultiplexer(a, b, weights=[10, 1], seed=0))
    assert ours == ids(jlazy.LazyIteratorMultiplexer(ja, jb, weights=[10, 1], seed=0))
    assert sum(1 for i in ours[:20] if not i.startswith("dummy-mono-cut-01")) > 14


def test_multiplexer_stop_early_equals_jax():
    (a, ja), (b, jb) = _dummies(0, 2), _dummies(100, 150)
    ours = ids(plazy.LazyIteratorMultiplexer(a, b, stop_early=True, seed=3))
    assert ours == ids(jlazy.LazyIteratorMultiplexer(ja, jb, stop_early=True, seed=3))
    assert len(ours) < 52


@pytest.mark.parametrize("n_sources,weights", [(1, None), (2, [1]), (3, [1, 2])])
def test_multiplexer_refuses_as_jax(n_sources, weights):
    made = [_dummies(10 * i, 10 * i + 3) for i in range(n_sources)]
    with pytest.raises(AssertionError):
        jlazy.LazyIteratorMultiplexer(*(j for _, j in made), weights=weights)
    with pytest.raises(AssertionError):
        plazy.LazyIteratorMultiplexer(*(p for p, _ in made), weights=weights)


@pytest.mark.parametrize("after", [0, 11, 39, 40])
def test_multiplexer_pickled_resume_equals_jax(tmp_path, after):
    (a1, ja1), (b1, jb1) = _lazy_pair(tmp_path, 0, 20, "a"), _lazy_pair(tmp_path, 100, 120, "b")
    full = ids(plazy.LazyIteratorMultiplexer(a1, b1, seed=42))
    assert full == ids(jlazy.LazyIteratorMultiplexer(ja1, jb1, seed=42))

    (a2, _), (b2, _) = _lazy_pair(tmp_path, 0, 20, "a2"), _lazy_pair(tmp_path, 100, 120, "b2")
    mux2 = plazy.LazyIteratorMultiplexer(a2, b2, seed=42)
    it = iter(mux2)
    head = [next(it).id for _ in range(after)]
    state = pickle.loads(pickle.dumps(mux2.state_dict()))

    (a3, _), (b3, _) = _lazy_pair(tmp_path, 0, 20, "a3"), _lazy_pair(tmp_path, 100, 120, "b3")
    mux3 = plazy.LazyIteratorMultiplexer(a3, b3, seed=42)
    mux3.load_state_dict(state)
    assert head + ids(mux3) == full


def test_multiplexer_state_crosses_packages(tmp_path):
    """A JAX mux's state after 13 items, through JSON, resumes the port's."""
    (a, ja), (b, jb) = _lazy_pair(tmp_path, 0, 20, "a"), _lazy_pair(tmp_path, 100, 120, "b")
    jmux = jlazy.LazyIteratorMultiplexer(ja, jb, weights=[2, 1], seed=5)
    full = ids(jlazy.LazyIteratorMultiplexer(ja, jb, weights=[2, 1], seed=5))
    it = iter(jmux)
    head = [next(it).id for _ in range(13)]
    state = json.loads(json.dumps(jmux.state_dict()))
    ours = plazy.LazyIteratorMultiplexer(a, b, weights=[2, 1], seed=5)
    ours.load_state_dict(state)
    assert head + ids(ours) == full


def test_infinite_mux_equals_jax_and_refuses_a_checkpoint():
    made = [_dummies(i * 10, i * 10 + 3) for i in range(4)]
    ours = plazy.LazyInfiniteApproximateMultiplexer(
        *(p for p, _ in made), weights=[1, 2, 3, 4], max_open_streams=2, seed=0)
    theirs = jlazy.LazyInfiniteApproximateMultiplexer(
        *(j for _, j in made), weights=[1, 2, 3, 4], max_open_streams=2, seed=0)
    it, jit = iter(ours), iter(theirs)
    drawn = [next(it).id for _ in range(50)]
    assert drawn == [next(jit).id for _ in range(50)]
    assert len(set(drawn)) > 3
    assert not ours.is_checkpointable
    with pytest.raises(NotImplementedError):
        theirs.state_dict()
    with pytest.raises(NotImplementedError):
        ours.state_dict()


@pytest.mark.parametrize("max_open_streams,seed", [(None, 1), (1, 2), (3, 9)])
def test_cutset_mux_classmethods_equal_jax(max_open_streams, seed):
    made = [_dummies(i * 10, i * 10 + 4) for i in range(3)]
    port_sets, jax_sets = [p for p, _ in made], [j for _, j in made]
    muxed = CutSet.mux(*port_sets, weights=[1, 2, 1], seed=seed)
    assert isinstance(muxed, CutSet) and muxed.is_lazy
    assert ids(muxed) == ids(J.CutSet.mux(*jax_sets, weights=[1, 2, 1], seed=seed))
    inf = CutSet.infinite_mux(*port_sets, seed=seed, max_open_streams=max_open_streams)
    jinf = J.CutSet.infinite_mux(*jax_sets, seed=seed, max_open_streams=max_open_streams)
    it, jit = iter(inf), iter(jinf)
    assert [next(it).id for _ in range(30)] == [next(jit).id for _ in range(30)]


# -- the mux pipeline sweep (tests/test_e2e_checkpoint_sweep.py) ---------------------------------
def _indexed_cuts(tmp_path, name, n, start=0):
    """``n`` tone WAVs of 1.0-1.1 s, an indexed JSONL manifest of their cuts
    written by the port; returns the port's and the JAX package's sets."""
    from lhotse_tpu_torch.audio.wavio import write_wav

    out = []
    for i in range(start, start + n):
        dur = 1.0 + 0.05 * (i % 3)
        ns = int(dur * SR)
        p = tmp_path / f"{name}{i}.wav"
        write_wav(str(p), (0.1 * np.sin(2 * np.pi * (100 + i) * np.arange(ns) / SR)).astype(
            np.float32), SR)
        c = Recording.from_file(p, recording_id=f"{name}{i}").to_cut()
        c.supervisions = [SupervisionSegment(
            id=f"{name}{i}-sup", recording_id=c.recording_id, start=0, duration=dur)]
        out.append(c)
    path = tmp_path / f"{name}.jsonl"
    CutSet.from_cuts(out).to_file(path)
    create_jsonl_index(path)
    return CutSet.from_file(path), J.CutSet.from_file(path)


class _FeatureDataset:
    """ids + on-the-fly fbank, enough to verify exact batch equality."""

    def __init__(self, extract):
        self.extract = extract

    def __getitem__(self, cuts):
        feats, lens = self.extract(cuts)[:2]
        return {"ids": [c.id for c in cuts], "feats": np.asarray(feats), "lens": np.asarray(lens)}


def test_mux_pipeline_sweep_equals_jax(tmp_path):
    a, ja = _indexed_cuts(tmp_path, "a", 8)
    b, jb = _indexed_cuts(tmp_path, "b", 6, start=100)

    def make():
        sampler = DynamicCutSampler(CutSet.mux(a, b, seed=3), max_cuts=3)
        return DataLoader(sampler, _FeatureDataset(OnTheFlyFeatures(Fbank(FbankConfig(
            device="cpu")))), prefetch_batches=1)

    jloader = JDataLoader(JDynamicCutSampler(J.CutSet.mux(ja, jb, seed=3), max_cuts=3),
                          _FeatureDataset(JOnTheFly(J.Fbank())), prefetch_batches=1)
    baseline = [b["ids"] for b in make()]
    assert baseline == [b["ids"] for b in jloader]
    assert len(baseline) >= 3
    for k in range(len(baseline) + 1):
        loader = make()
        it = iter(loader)
        head = [next(it)["ids"] for _ in range(k)]
        state = loader.state_dict()
        it.close()
        resumed = make()
        resumed.load_state_dict(state)
        rest = list(resumed)
        assert head + [b["ids"] for b in rest] == baseline, f"diverged at k={k}"
        if rest:
            again = make()
            again.load_state_dict(state)
            np.testing.assert_array_equal(next(iter(again))["feats"], rest[0]["feats"])


# -- DataloaderCheckpoint (tests/test_checkpoint_api.py) -----------------------------------------
def _repeat_pipeline(cutset_cls, path):
    return cutset_cls.from_jsonl_lazy(path).repeat(2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dataloader_checkpoint_json_roundtrip(tmp_path, writer):
    """As the JAX test, with the checkpoint written by either package and
    loaded by the port; the ids equal the JAX pipeline's."""
    path = tmp_path / "cuts.jsonl.gz"
    DummyManifest(CutSet, begin_id=0, end_id=30).to_file(path)
    cls, mod = (CutSet, pckpt) if writer == "port" else (J.CutSet, jckpt)
    pipe = _repeat_pipeline(cls, path)
    it = iter(pipe)
    for _ in range(5):
        next(it)
    ckpt = mod.DataloaderCheckpoint(
        num_workers=2, world_size=4, rank=1, worker_states=[mod.collect_state_dict(pipe.data)],
        sampler_state={"step": 5})
    file = tmp_path / "ckpt.json"
    ckpt.save(file)
    json.loads(file.read_text())

    loaded = pckpt.DataloaderCheckpoint.load(file)
    assert loaded.num_workers == 2 and loaded.rank == 1
    assert loaded.sampler_state == {"step": 5}
    loaded.validate(num_workers=2, world_size=4, rank=1)
    with pytest.raises(ValueError, match="world_size"):
        loaded.validate(num_workers=2, world_size=8, rank=1)
    with pytest.raises(ValueError, match="rank"):
        loaded.validate(num_workers=2, world_size=4, rank=0)

    full = ids(_repeat_pipeline(CutSet, path))
    assert full == ids(_repeat_pipeline(J.CutSet, path))
    fresh = _repeat_pipeline(CutSet, path)
    pckpt.restore_state_dict(fresh.data, loaded.worker_states[0])
    assert full[:5] + ids(fresh) == full


def test_dataloader_checkpoint_file_equals_jax(tmp_path):
    """The same checkpoint saved by both packages gives the same JSON."""
    path = tmp_path / "cuts.jsonl.gz"
    DummyManifest(CutSet, begin_id=0, end_id=12).to_file(path)
    written = []
    for cls, mod in ((CutSet, pckpt), (J.CutSet, jckpt)):
        pipe = _repeat_pipeline(cls, path)
        it = iter(pipe)
        for _ in range(17):
            next(it)
        out = tmp_path / f"{mod.__name__}.json"
        mod.DataloaderCheckpoint(num_workers=0, world_size=1, rank=0,
                                 worker_states=[mod.collect_state_dict(pipe.data)]).save(out)
        written.append(json.loads(out.read_text()))
    assert written[0] == written[1]


# -- loaders over muxed corpora ------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two seeded corpora of 16 kHz FLAC cuts of 0.4-1.9 s: "a" (7 cuts) and
    "b" (5 cuts), a 0.05 tone under 0.1 white noise (the noise keeps every
    mel bin well above float32 rounding), each an indexed JSONL manifest."""
    root = tmp_path_factory.mktemp("mux_corpora")
    rng = np.random.RandomState(21)
    paths = {}
    for name, n in (("a", 7), ("b", 5)):
        cuts = []
        for i in range(n):
            k = int(SR * rng.uniform(0.4, 1.9))
            wave = np.sin(2 * np.pi * rng.uniform(100, 400) * np.arange(k) / SR) * 0.05
            wave = (wave + rng.randn(k) * 0.1).astype(np.float32)
            path = root / f"{name}{i:02d}.flac"
            write_flac(str(path), wave, SR)
            cut = Recording.from_file(path).to_cut()
            cut.supervisions.append(SupervisionSegment(
                id=f"{name}{i}", recording_id=cut.recording_id, start=0.0, duration=cut.duration,
                text=name))
            cuts.append(cut)
        paths[name] = root / f"{name}.jsonl"
        CutSet.from_cuts(cuts).to_file(paths[name])
    return paths


def _bucketing(cutset_cls, sampler_cls, corpora, seed=5):
    muxed = cutset_cls.mux(*(cutset_cls.from_jsonl_lazy(corpora[n]) for n in "ab"),
                           weights=[2, 1], seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return sampler_cls(muxed, max_duration=4.0, num_buckets=2, buffer_size=16, shuffle=True,
                           seed=0)


def _cpu_fbank():
    return Fbank(FbankConfig(device="cpu"))


def _muxed_loader(pkg, corpora, mvn):
    """mux → DynamicBucketingSampler → OnTheFlyFeatures → GlobalMVN and
    SpecAugment (a ``checkpoint_objects`` entry) → DataLoader, in either
    package; with the list that records each SpecAugment draw."""
    drawn = []
    if pkg == "port":
        specaug = SpecAugment(time_warp_factor=5, frames_mask_size=10, seed=3)
        dataset_cls, strategy = K2SpeechRecognitionDataset, OnTheFlyFeatures(_cpu_fbank())
        sampler = _bucketing(CutSet, DynamicBucketingSampler, corpora)
        loader_cls = DataLoader
    else:
        specaug = JSpecAugment(time_warp_factor=5, frames_mask_size=10, seed=3)
        dataset_cls, strategy = JDataset, JOnTheFly(J.Fbank())
        sampler = _bucketing(J.CutSet, JBucketing, corpora)
        loader_cls = JDataLoader

    def draw(feats, supervision_segments=None):
        drawn.append(len(feats))
        return specaug(feats, supervision_segments=supervision_segments)

    dataset = dataset_cls(return_cuts=True, input_strategy=strategy,
                          input_transforms=[mvn, draw])
    return loader_cls(sampler, dataset, prefetch_batches=2, checkpoint_objects=[specaug]), drawn


def _resume_after_run_ahead(make, tmp_path, ckpt_mod):
    """Batch 1 taken, then a wait until the producer has drawn SpecAugment
    for batch 3 (it runs ahead by the prefetch depth), then batch 2 and a
    ``DataloaderCheckpoint`` through JSON into a fresh loader. Returns the
    uninterrupted run and the head + resumed batches."""
    full = list(make()[0])
    loader, drawn = make()
    it = iter(loader)
    head = [next(it)]
    deadline = time.monotonic() + 120
    while len(drawn) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(drawn) >= 3, "the producer did not run ahead"
    head.append(next(it))
    ckpt_mod.DataloaderCheckpoint(num_workers=0, world_size=1, rank=0,
                                  sampler_state=loader.state_dict()).save(tmp_path / "ckpt.json")
    it.close()
    loaded = ckpt_mod.DataloaderCheckpoint.load(tmp_path / "ckpt.json")
    loaded.validate(num_workers=0, world_size=1, rank=0)
    resumed = make()[0]
    resumed.load_state_dict(loaded.sampler_state)
    return full, head + list(resumed)


def _same_batches(a, b) -> bool:
    return len(a) == len(b) and all(
        ids(x["supervisions"]["cut"]) == ids(y["supervisions"]["cut"])
        and np.array_equal(x["inputs"], y["inputs"]) for x, y in zip(a, b))


def test_loader_checkpoint_of_a_muxed_corpus_resumes_from_json(corpora, tmp_path):
    """A ``DataloaderCheckpoint`` written after batch 2, while the producer
    has run ahead, and read back into a fresh loader gives the uninterrupted
    run's remaining batches bit for bit: SpecAugment's ``state_dict`` takes
    no ``after=``, so the loader saves its producer's snapshot of batch 2."""
    mvn = GlobalMVN.from_cuts(CutSet.from_jsonl_lazy(corpora["a"]), extractor=_cpu_fbank())
    full, resumed = _resume_after_run_ahead(lambda: _muxed_loader("port", corpora, mvn),
                                            tmp_path, pckpt)
    assert len(full) >= 4 and _same_batches(resumed, full)
    with pytest.raises(TypeError):
        SpecAugment().state_dict(after=full[0])


def test_jax_specaugment_checkpoint_is_the_live_state(corpora, tmp_path):
    """The JAX fault the port keeps out (ROADMAP C2): JAX's
    ``SpecAugment.state_dict`` accepts and ignores ``after=``, so its loader
    saves the live generator state that the producer has run ahead with,
    and the resumed batches draw other masks than the uninterrupted run's."""
    jmvn = JGlobalMVN.from_cuts(J.CutSet.from_jsonl_lazy(corpora["a"]), extractor=J.Fbank())
    full, resumed = _resume_after_run_ahead(lambda: _muxed_loader("jax", corpora, jmvn),
                                            tmp_path, jckpt)
    assert [ids(b["supervisions"]["cut"]) for b in resumed] == [
        ids(b["supervisions"]["cut"]) for b in full]
    assert not _same_batches(resumed, full)
    JSpecAugment().state_dict(after=full[0])


class _Ids:
    def __getitem__(self, cuts):
        return {"ids": [c.id for c in cuts]}


def _infinite(cutset_cls, corpora):
    return cutset_cls.infinite_mux(
        *(cutset_cls.from_jsonl_lazy(corpora[n]) for n in "ab"), weights=[1, 3], seed=4,
        max_open_streams=1)


def test_infinite_mux_loader_resumes_by_replay_as_jax(corpora):
    """Over an ``infinite_mux`` the samplers capture no graph state (the
    mux has none) and fall back to replaying the batches they had drawn, in
    both packages: ``loader.state_dict()`` does not refuse, and under a fixed
    seed the replayed resume gives the uninterrupted run's next batches."""
    def run(cutset_cls, sampler_cls, loader_cls):
        def make():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sampler = sampler_cls(_infinite(cutset_cls, corpora), max_duration=4.0,
                                      num_buckets=2, buffer_size=16, shuffle=True, seed=0)
            return loader_cls(sampler, _Ids(), prefetch_batches=1)

        it = iter(make())
        full = [next(it)["ids"] for _ in range(8)]
        it.close()
        loader = make()
        it = iter(loader)
        head = [next(it)["ids"] for _ in range(3)]
        state = json.loads(json.dumps(loader.state_dict()))
        it.close()
        assert "cuts_state" not in state["sampler"]
        resumed = make()
        resumed.load_state_dict(state)
        it = iter(resumed)
        tail = [next(it)["ids"] for _ in range(5)]
        it.close()
        assert head + tail == full
        return full

    assert run(CutSet, DynamicBucketingSampler, DataLoader) == run(
        J.CutSet, JBucketing, JDataLoader)


def _batches_of_three(cuts):
    it = iter(cuts)
    while True:
        yield type(cuts).from_cuts([next(it) for _ in range(3)])


def test_loader_over_a_sampler_without_state_iterates_and_refuses_state_dict_as_jax(corpora):
    """Batches taken straight off an ``infinite_mux`` (a sampler with no
    ``state_dict``): the loader's per-batch snapshot gives up quietly, so
    the loader iterates, and ``state_dict()`` refuses loudly, as JAX's does."""
    def run(cutset_cls, loader_cls):
        loader = loader_cls(_batches_of_three(_infinite(cutset_cls, corpora)), _Ids(),
                            prefetch_batches=1)
        it = iter(loader)
        got = [next(it)["ids"] for _ in range(6)]
        with pytest.raises(AttributeError, match="state_dict"):
            loader.state_dict()
        it.close()
        return got

    ours = run(CutSet, DataLoader)
    assert ours == run(J.CutSet, JDataLoader)
    assert all(len(b) == 3 for b in ours)


def test_muxed_slice_holds_to_jax_kernel_route(corpora):
    """The slice in both packages: the same cut ids batch by batch; the
    port's normalised features within 1e-4 of the JAX layer's kernel route
    (XLA) over the JAX dataset's audio of the same batch, normalised by the
    JAX ``GlobalMVN`` computed over the same corpus."""
    stats_cuts = [CutSet.from_jsonl_lazy(corpora["b"]), J.CutSet.from_jsonl_lazy(corpora["b"])]
    mvn = GlobalMVN.from_cuts(stats_cuts[0], extractor=_cpu_fbank())
    jmvn = JGlobalMVN.from_cuts(stats_cuts[1], extractor=J.Fbank())
    np.testing.assert_allclose(mvn.norm_means, jmvn.norm_means, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mvn.norm_stds, jmvn.norm_stds, rtol=0, atol=1e-5)
    ours = [K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(_cpu_fbank()),
        input_transforms=[mvn])[b] for b in _bucketing(CutSet, DynamicBucketingSampler, corpora)]
    jds = JDataset(return_cuts=True, input_strategy=JAudioSamples())
    theirs = [jds[b] for b in _bucketing(J.CutSet, JBucketing, corpora)]
    assert len(ours) == len(theirs) >= 3
    layer = jl.Wav2LogFilterBank()
    worst, sources = 0.0, set()
    for a, b in zip(ours, theirs):
        assert ids(a["supervisions"]["cut"]) == ids(b["supervisions"]["cut"])
        sources |= {c.supervisions[0].text for c in a["supervisions"]["cut"]}
        for i, c in enumerate(b["supervisions"]["cut"]):
            route = _jax_fused_route(layer, b["inputs"][i : i + 1, : c.num_samples])
            want = jmvn(np.asarray(route)[0])
            got = a["inputs"][i, : want.shape[0]]
            assert a["supervisions"]["num_frames"][i] <= want.shape[0] <= a["inputs"].shape[1]
            worst = max(worst, float(np.abs(got - want).max()))
    assert sources == {"a", "b"}
    assert worst <= FEATURE_TOL, worst
