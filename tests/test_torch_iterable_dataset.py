"""
Shar through the port's dataset layer, against the JAX package:
``IterableDatasetWrapper`` in a ``torch.utils.data.DataLoader`` with two
worker processes over ``CutSet.from_shar(split_for_dataloading=True)``, its
state dict, ``OnTheFlyFeatures(Fbank(device="cpu"))`` over Shar batches
against the JAX fbank layer's kernel route, and ``DynamicBucketingSampler``'s
constant-time (seek) resume over indexed Shar.

Tolerances: cut ids, orders and state dicts exactly; features extracted on
the fly at 1e-4 from the JAX layer's kernel route in XLA (the feature
budget; tests/test_torch_cut_transforms.py holds the same path to it).
"""
import copy
import warnings

import numpy as np
import pytest
import torch

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.sampling.dynamic_bucketing import DynamicBucketingSampler as JSampler
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi import layers as jl
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import dataloading as pdl
from lhotse_tpu_torch.dataset.input_strategies import AudioSamples, OnTheFlyFeatures
from lhotse_tpu_torch.dataset.iterable_dataset import IdentityDataset, IterableDatasetWrapper
from lhotse_tpu_torch.dataset.sampling import checkpoint_backends
from lhotse_tpu_torch.dataset.sampling import dynamic_bucketing as pdb
from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import DynamicBucketingSampler
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from test_torch_layers import _jax_fused_route

SR = 16000
N_CUTS = 12
FEATURE_TOL = 1e-4


@pytest.fixture(scope="module")
def shar_dir(tmp_path_factory):
    """Twelve FLAC tone bursts of 0.4-1.2 s exported by the JAX package to
    6 indexed Shar shards (FLAC recordings)."""
    root = tmp_path_factory.mktemp("iterable")
    rng = np.random.RandomState(7)
    cuts = []
    for i in range(N_CUTS):
        n = int(SR * rng.uniform(0.4, 1.2))
        t = np.arange(n) / SR
        wave = 0.2 * np.sin(2 * np.pi * rng.uniform(80, 220) * t) + rng.randn(n) * 0.01
        jwrite_flac(str(root / f"utt{i:02d}.flac"), wave.astype(np.float32), SR)
        cut = J.Recording.from_file(root / f"utt{i:02d}.flac").to_cut()
        cut.supervisions.append(J.SupervisionSegment(
            id=f"sup{i:02d}", recording_id=cut.recording_id, start=0.0, duration=cut.duration))
        cuts.append(cut)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        J.CutSet.from_cuts(cuts).to_shar(root / "shar", fields={"recording": "flac"}, shard_size=2,
                                         compress_jsonl=False)
    return root / "shar"


def _sampler(cls_cut, cls_sampler, shar_dir, **kw):
    cuts = cls_cut.from_shar(in_dir=shar_dir, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls_sampler(cuts, max_duration=2.5, num_buckets=2, shuffle=True, seed=0,
                           buffer_size=8)


def test_wrapper_in_torch_dataloader_covers_every_cut(shar_dir):
    """Two spawned workers, each with its replica of the sampler over its
    half of the shards: every cut once per epoch, the workers' shards
    disjoint, each batch stamped with the rank."""
    sampler = _sampler(CutSet, DynamicBucketingSampler, shar_dir, indexed=False,
                       split_for_dataloading=True, shuffle_shards=True, seed=0)
    wrapper = IterableDatasetWrapper(IdentityDataset(), sampler)
    assert isinstance(wrapper, torch.utils.data.IterableDataset)
    loader = torch.utils.data.DataLoader(
        wrapper, batch_size=None, num_workers=2, multiprocessing_context="spawn",
        worker_init_fn=pdl.make_worker_init_fn(seed=0))
    epochs = []
    for epoch in range(2):
        wrapper.set_epoch(epoch)
        by_shard = {}
        ids = []
        for batch in loader:
            for cut in batch:
                ids.append(cut.id)
                by_shard.setdefault(str(cut.shard_origin), set()).add(cut.dataloading_info["worker_id"])
                assert cut.dataloading_info["rank"] == 0 and cut.dataloading_info["world_size"] == 1
        assert sorted(ids) == [f"utt{i:02d}" for i in range(N_CUTS)]
        assert len(by_shard) == 6 and all(len(w) == 1 for w in by_shard.values())
        assert {w for ws in by_shard.values() for w in ws} == {0, 1}
        epochs.append(ids)
    assert sampler.epoch == 1


def test_wrapper_state_dict_resumes(shar_dir):
    def wrapper():
        return IterableDatasetWrapper(K2SpeechRecognitionDataset(
            return_cuts=True, input_strategy=AudioSamples()), _sampler(
                CutSet, DynamicBucketingSampler, shar_dir, indexed=True, shuffle_shards=True, seed=4))

    first = wrapper()
    it = iter(first)
    head = [next(it) for _ in range(2)]
    state = copy.deepcopy(first.state_dict())
    rest = list(it)
    resumed = wrapper()
    resumed.load_state_dict(state)
    got = list(resumed)
    assert [[c.id for c in b["supervisions"]["cut"]] for b in got] == [
        [c.id for c in b["supervisions"]["cut"]] for b in rest]
    for a, b in zip(got, rest):
        assert np.array_equal(a["inputs"], b["inputs"])
    assert sum(len(b["supervisions"]["cut"]) for b in head + rest) == N_CUTS
    auto = IterableDatasetWrapper(IdentityDataset(), _sampler(
        CutSet, DynamicBucketingSampler, shar_dir, indexed=False), auto_increment_epoch=True)
    list(auto)
    assert auto.epoch == 1 and auto.sampler.epoch == 1


def test_shar_on_the_fly_features_hold_to_jax_kernel_route(shar_dir):
    """Indexed, shuffled Shar → the sampler → ``OnTheFlyFeatures`` on the
    port's CPU route, against the JAX layer's kernel route over the JAX
    dataset's audio of the same batches."""
    ours = _sampler(CutSet, DynamicBucketingSampler, shar_dir, shuffle_shards=True, seed=1)
    theirs = _sampler(J.CutSet, JSampler, shar_dir, shuffle_shards=True, seed=1)
    fly = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    ref = JDataset(return_cuts=True, input_strategy=JAudioSamples())
    layer = jl.Wav2LogFilterBank()
    worst, n = 0.0, 0
    for a_cuts, b_cuts in zip(ours, theirs):
        assert [c.id for c in a_cuts] == [c.id for c in b_cuts]
        a, b = fly[a_cuts], ref[b_cuts]
        for i, c in enumerate(b["supervisions"]["cut"]):
            want = np.asarray(_jax_fused_route(layer, b["inputs"][i : i + 1, : c.num_samples]))[0]
            worst = max(worst, float(np.abs(a["inputs"][i, : want.shape[0]] - want).max()))
            n += 1
    assert n == N_CUTS and worst <= FEATURE_TOL, worst


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_sampler_seek_resume_over_indexed_shar_equals_jax(shar_dir, monkeypatch, src, dst):
    """The same batches as the JAX sampler; a checkpoint after 2 batches
    resumes the other package's sampler through the seek backend."""
    pairs = {"port": (CutSet, DynamicBucketingSampler), "jax": (J.CutSet, JSampler)}
    kw = dict(shuffle_shards=True, seed=5)
    a, b = _sampler(*pairs["port"], shar_dir, **kw), _sampler(*pairs["jax"], shar_dir, **kw)
    assert [[c.id for c in x] for x in a] == [[c.id for c in x] for x in b]
    first = _sampler(*pairs[src], shar_dir, **kw)
    it = iter(first)
    head = [[c.id for c in next(it)] for _ in range(2)]
    state = copy.deepcopy(first.state_dict())
    rest = []
    while (batch := next(it, None)) is not None:  # iter(sampler) would restart the epoch
        rest.append([c.id for c in batch])
    chosen = []
    real = pdb.plan_resume
    monkeypatch.setattr(pdb, "plan_resume", lambda *args, **kws: chosen.append(
        real(*args, **kws)) or chosen[-1])
    resumed = _sampler(*pairs[dst], shar_dir, **kw)
    resumed.load_state_dict(state)
    assert [[c.id for c in x] for x in resumed] == rest
    assert sum(map(len, head + rest)) == N_CUTS
    if dst == "port":
        assert len(chosen) == 1 and isinstance(chosen[0], checkpoint_backends.SeekResume)
