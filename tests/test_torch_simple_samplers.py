"""
The port's eager samplers (lhotse_tpu_torch.dataset.sampling.simple,
bucketing, data_source and utils) against the JAX package's on the same
manifest: the same cut ids per batch, in order, epoch by epoch, for one rank
and for both ranks of two, with and without ``drop_last`` and ``shuffle``;
the same state dict after k batches, each package's state dict resuming in
the other's sampler; and the same pessimistic batches.
"""
import copy

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.dataset.sampling import BucketingSampler as JBucketing
from lhotse_tpu.dataset.sampling import SimpleCutSampler as JSimple
from lhotse_tpu.dataset.sampling import find_pessimistic_batches as jfind_pessimistic
from lhotse_tpu.dataset.sampling import report_padding_ratio_estimate as jreport
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import (
    BucketingSampler, SimpleCutSampler, find_pessimistic_batches, report_padding_ratio_estimate)

SR = 16000


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """37 cuts of 0.3-2.4 s, one or two supervisions each (manifests only:
    the samplers read no audio)."""
    path = tmp_path_factory.mktemp("simple_sampling") / "cuts.jsonl.gz"
    rng = np.random.default_rng(7)
    cuts = []
    for i in range(37):
        n = int(SR * rng.uniform(0.3, 2.4))
        rec = J.Recording(id=f"rec{i:03d}", sampling_rate=SR, num_samples=n, duration=n / SR,
                          sources=[J.AudioSource(type="file", channels=[0], source=f"r{i}.flac")])
        cut = rec.to_cut()
        half = round(cut.duration / 2, 4)
        cut.supervisions.append(J.SupervisionSegment(
            id=f"sup{i:03d}", recording_id=rec.id, start=0.0, duration=half if i % 3 else cut.duration))
        if i % 3:
            cut.supervisions.append(J.SupervisionSegment(
                id=f"sup{i:03d}b", recording_id=rec.id, start=half, duration=cut.duration - half))
        cuts.append(cut)
    J.CutSet.from_cuts(cuts).to_file(path)
    return path


def _simple(manifest, lazy=False, **kw):
    ours = CutSet.from_file(manifest)
    theirs = J.CutSet.from_file(manifest)
    if not lazy:
        ours, theirs = ours.to_eager(), theirs.to_eager()
    return SimpleCutSampler(ours, **kw), JSimple(theirs, **kw)


def _bucketing(manifest, **kw):
    return (BucketingSampler(CutSet.from_file(manifest).to_eager(), **kw),
            JBucketing(J.CutSet.from_file(manifest).to_eager(), **kw))


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
OPTIONS = [dict(max_duration=5.0), dict(max_duration=5.0, shuffle=True, seed=3),
           dict(max_duration=4.0, shuffle=True, drop_last=True), dict(max_cuts=4, shuffle=True)]


@pytest.mark.parametrize("world_size,rank", TOPOLOGIES)
@pytest.mark.parametrize("options", OPTIONS)
@pytest.mark.parametrize("lazy", [False, True])
def test_simple_sampler_batches(manifest, world_size, rank, options, lazy):
    ours, theirs = _simple(manifest, lazy=lazy, world_size=world_size, rank=rank, **options)
    assert (ours.num_cuts, ours.remaining_cuts) == (theirs.num_cuts, theirs.remaining_cuts)
    seen = []
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = _ids(ours)
        assert got == _ids(theirs), epoch
        assert all(len(b) > 0 for b in got)
        seen.append(got)
    if options.get("shuffle"):
        assert seen[0] != seen[1]
    if world_size == 1 and not options.get("drop_last"):
        assert sorted(i for b in seen[0] for i in b) == sorted(
            c.id for c in CutSet.from_file(manifest))
    assert ours.diagnostics.get_report() == theirs.diagnostics.get_report()


@pytest.mark.parametrize("world_size,rank", TOPOLOGIES)
@pytest.mark.parametrize("options", [
    dict(num_buckets=3, max_duration=5.0), dict(num_buckets=4, max_duration=4.0, shuffle=True),
    dict(num_buckets=2, max_duration=6.0, shuffle=True, drop_last=True, seed=11)])
def test_bucketing_sampler_batches(manifest, world_size, rank, options):
    ours, theirs = _bucketing(manifest, world_size=world_size, rank=rank, **options)
    assert [[c.id for c in b[0]] for b in ours.buckets] == [
        [c.id for c in b[0]] for b in theirs.buckets]
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = _ids(ours)
        assert got == _ids(theirs), epoch
        # Each batch comes from one duration bucket (a straggler duplicate
        # carries a "_dup" suffix).
        bucket_of = {c.id: k for k, (b,) in enumerate(ours.buckets) for c in b}
        assert all(len({bucket_of[i.split("_dup")[0]] for i in batch}) == 1 for batch in got)
    assert ours.num_cuts == theirs.num_cuts == 37
    assert ours.remaining_duration == pytest.approx(theirs.remaining_duration)


def test_bucketing_sampler_refuses_lazy_cuts(manifest):
    with pytest.raises(ValueError, match="lazy CutSet"):
        BucketingSampler(CutSet.from_file(manifest), max_duration=5.0)


def test_ranks_split_the_epoch(manifest):
    """The two ranks of either sampler see disjoint batches that cover the
    data (the stragglers' duplicates aside)."""
    for make in (_simple, _bucketing):
        extra = dict(num_buckets=3) if make is _bucketing else {}
        rank0 = make(manifest, world_size=2, rank=0, max_duration=5.0, **extra)[0]
        rank1 = make(manifest, world_size=2, rank=1, max_duration=5.0, **extra)[0]
        ids0 = {i for b in _ids(rank0) for i in b}
        ids1 = {i for b in _ids(rank1) for i in b}
        assert len(ids0 | ids1) == 37 and len(ids0 & ids1) <= 2


@pytest.mark.parametrize("sampler", ["simple", "bucketing"])
@pytest.mark.parametrize("world_size,rank", TOPOLOGIES)
@pytest.mark.parametrize("k", [0, 3])
def test_state_dict_resumes_across_packages(manifest, sampler, world_size, rank, k):
    def pair():
        if sampler == "simple":
            return _simple(manifest, world_size=world_size, rank=rank, max_duration=5.0,
                           shuffle=True, seed=2)
        return _bucketing(manifest, world_size=world_size, rank=rank, num_buckets=3,
                          max_duration=5.0, shuffle=True, seed=2)

    ours, theirs = pair()
    ours.set_epoch(1)
    theirs.set_epoch(1)
    it_ours, it_theirs = iter(ours), iter(theirs)
    for _ in range(k):
        assert [c.id for c in next(it_ours)] == [c.id for c in next(it_theirs)]
    sd_ours, sd_theirs = ours.state_dict(), theirs.state_dict()
    assert sd_ours == sd_theirs
    rest = _drain(theirs)
    assert _drain(ours) == rest and len(rest) > 0

    # Each package's checkpoint resumes in the other's fresh sampler.
    for state in (sd_theirs, sd_ours):
        for fresh in pair():
            fresh.load_state_dict(copy.deepcopy(state))
            assert _ids(fresh) == rest, (type(fresh).__module__, k)


def test_pessimistic_batches_and_padding_report(manifest):
    ours, theirs = _simple(manifest, max_duration=5.0, shuffle=True)
    (batches, scores), (jbatches, jscores) = find_pessimistic_batches(ours), jfind_pessimistic(theirs)
    assert scores == jscores and len(scores) == 6
    assert {k: [c.id for c in v] for k, v in batches.items()} == {
        k: [c.id for c in v] for k, v in jbatches.items()}
    ours, theirs = _bucketing(manifest, num_buckets=3, max_duration=5.0)
    assert report_padding_ratio_estimate(ours, n_samples=20) == jreport(theirs, n_samples=20)
