"""
The port's DynamicBucketingSampler (lhotse_tpu_torch.dataset.sampling)
against the JAX package's on the same lazy manifest: the same cut ids per
batch, in order, over two epochs, under FixedBucketBatchSizeConstraint and
under max_duration, shuffled, for one rank and for both ranks of two; the
same state dict after k batches; and each package's state dict resumes in
the other's sampler with the same batches.
"""
import copy

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.dataset.sampling.dynamic_bucketing import (
    DynamicBucketingSampler as JSampler, FixedBucketBatchSizeConstraint as JFixed)
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
    DynamicBucketingSampler, FixedBucketBatchSizeConstraint)

SR = 16000
BUCKETS = [(0.8, 4), (1.3, 3), (2.0, 2)]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """41 cuts of 0.3-1.95 s (manifests only: the sampler reads no audio)."""
    path = tmp_path_factory.mktemp("sampling") / "cuts.jsonl.gz"
    rng = np.random.default_rng(4)
    cuts = []
    for i in range(41):
        n = int(SR * rng.uniform(0.3, 1.95))
        rec = J.Recording(id=f"rec{i:03d}", sampling_rate=SR, num_samples=n, duration=n / SR,
                          sources=[J.AudioSource(type="file", channels=[0], source=f"r{i}.flac")])
        cut = rec.to_cut()
        cut.supervisions.append(J.SupervisionSegment(
            id=f"sup{i:03d}", recording_id=rec.id, start=0.0, duration=cut.duration))
        cuts.append(cut)
    J.CutSet.from_cuts(cuts).to_file(path)
    return path


def _kwargs(kind, fixed_cls):
    if kind == "fixed":
        return dict(constraint=fixed_cls(max_seq_len_buckets=[ub for ub, _ in BUCKETS],
                                         batch_sizes=[b for _, b in BUCKETS]),
                    num_buckets=None, duration_bins=[ub for ub, _ in BUCKETS[:-1]])
    return dict(max_duration=4.0, num_buckets=3)


def _pair(manifest, kind, world_size, rank, seed=0):
    common = dict(shuffle=True, seed=seed, buffer_size=30, world_size=world_size, rank=rank)
    ours = DynamicBucketingSampler(CutSet.from_jsonl_lazy(manifest), **_kwargs(kind, FixedBucketBatchSizeConstraint), **common)
    theirs = JSampler(J.CutSet.from_jsonl_lazy(manifest), **_kwargs(kind, JFixed), **common)
    return ours, theirs


def _ids(batches):
    return [[c.id for c in b] for b in batches]


def _drain(sampler):
    """The rest of an epoch that is under way (``iter()`` would restart it)."""
    out = []
    while True:
        try:
            out.append([c.id for c in next(sampler)])
        except StopIteration:
            return out


TOPOLOGIES = [(1, 0), (2, 0), (2, 1)]


@pytest.mark.parametrize("kind", ["fixed", "max_duration"])
@pytest.mark.parametrize("world_size,rank", TOPOLOGIES)
def test_same_batches_over_two_epochs(manifest, kind, world_size, rank):
    ours, theirs = _pair(manifest, kind, world_size, rank)
    assert ours.duration_bins == theirs.duration_bins
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = _ids(ours), _ids(theirs)
        assert a == b and len(a) >= 5, (epoch, len(a))
    assert ours.diagnostics.state_dict() == theirs.diagnostics.state_dict()


def test_every_cut_once_and_buckets_respected(manifest):
    ours, _ = _pair(manifest, "fixed", 1, 0)
    batches = list(ours)
    ids = [c.id for b in batches for c in b]
    assert sorted(ids) == [f"rec{i:03d}" for i in range(41)]
    for b in batches:
        durs = [c.duration for c in b]
        ub, size = next((ub, size) for ub, size in BUCKETS if max(durs) < ub)
        assert len(b) <= size and all(d < ub for d in durs)


@pytest.mark.parametrize("kind", ["fixed", "max_duration"])
@pytest.mark.parametrize("world_size,rank", TOPOLOGIES)
@pytest.mark.parametrize("k", [0, 3])
def test_state_dict_equal_and_resumes_across_packages(manifest, kind, world_size, rank, k):
    ours, theirs = _pair(manifest, kind, world_size, rank)
    ours.set_epoch(1)
    theirs.set_epoch(1)
    it_ours, it_theirs = iter(ours), iter(theirs)
    for _ in range(k):
        assert [c.id for c in next(it_ours)] == [c.id for c in next(it_theirs)]
    sd_ours, sd_theirs = ours.state_dict(), theirs.state_dict()
    assert sd_ours == sd_theirs
    rest = _drain(theirs)
    assert _drain(ours) == rest

    # Each package's checkpoint resumes in the other's fresh sampler.
    for state in (sd_theirs, sd_ours):
        for fresh in _pair(manifest, kind, world_size, rank):
            fresh.load_state_dict(copy.deepcopy(state))
            assert _ids(fresh) == rest, (type(fresh).__module__, k)
