"""
The port's combined samplers (lhotse_tpu_torch.dataset.sampling:
``ZipSampler``, ``RoundRobinSampler``, ``WeightedSimpleCutSampler`` over
``WeightedDataSource``, ``StatelessSampler`` with ``ManifestIndex``, and the
``DynamicCutSampler`` that ``StatelessSampler`` batches with) against the
JAX package's on the same manifests: the same cut ids per batch, in order,
over two epochs; the same state dict after k batches, loaded by the other
package's fresh sampler with the same rest of the epoch; the same ``.idx``
bytes. Then the slice as a whole at a small size: two sources (one
loudness-normalised, one narrowbanded) → ``ZipSampler`` →
``CutConcatenate``, ``ClippingTransform`` and ``LowpassUsingResampling`` →
``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures``, against the JAX
chain: the same cut ids and supervisions, the same audio
(``AudioSamples``, exactly), and features within ``FEATURE_TOL`` of the
JAX fbank layer's kernel route evaluated in float64 on the JAX chain's
audio. A cut lowpassed at 4 kHz leaves the mel bins above its cutoff near
silent: there the JAX float32 routes part from float64 by up to 6.9e-4
(the kernel route in XLA) and the port's CPU route, whose DFT products are
float64, by under 1e-6.

Sampler state dicts hold random states as tuples: they are copied with
``copy.deepcopy``. ``iter(sampler)`` restarts an epoch, so a sampler is
drained mid-epoch with ``next()``.
"""
import copy
import itertools
import pickle
import warnings

import numpy as np
import pytest

import lhotse_tpu as J
import lhotse_tpu.dataset.sampling as JS
from lhotse_tpu.audio.wavio import write_wav as jwrite_wav
from lhotse_tpu.dataset import cut_transforms as JT
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi import layers as jl
from lhotse_tpu.testing.dummies import DummyManifest as JDummyManifest
from lhotse_tpu.utils import fastcopy as jfastcopy
from lhotse_tpu.utils import fix_random_seed as jfix
import lhotse_tpu_torch.dataset.sampling as PS
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import cut_transforms as PT
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.testing.dummies import DummyManifest
from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
from lhotse_tpu_torch.utils import fastcopy, fix_random_seed

SR = 16000
FEATURE_TOL = 1e-4  # the feature budget
PORT, JAX = "port", "jax"


def _cuts(pkg, n, prefix, durations=(1.0, 1.5, 2.0, 0.5)):
    """``n`` dummy cuts named ``prefix-dummy-mono-cut-NNNN`` with cycling durations."""
    manifest, cutset, copy_ = ((DummyManifest, CutSet, fastcopy) if pkg == PORT
                               else (JDummyManifest, J.CutSet, jfastcopy))
    cuts = manifest(cutset, begin_id=0, end_id=n)
    return cutset.from_cuts(
        copy_(c, id=f"{prefix}-{c.id}", duration=durations[i % len(durations)])
        for i, c in enumerate(cuts))


def _ns(pkg):
    return PS if pkg == PORT else JS


def _ids(batch):
    if isinstance(batch, tuple):
        return tuple(_ids(b) for b in batch)
    return [c.id for c in batch]


def _drain(sampler):
    """The rest of an epoch that is under way (``iter()`` would restart it)."""
    out = []
    while True:
        try:
            out.append(_ids(next(sampler)))
        except StopIteration:
            return out


def _zip(pkg, merge_batches=True, shuffle=True):
    S = _ns(pkg)
    return S.ZipSampler(
        S.SimpleCutSampler(_cuts(pkg, 12, "a"), max_duration=3.0, shuffle=shuffle, seed=1),
        S.SimpleCutSampler(_cuts(pkg, 20, "b"), max_cuts=3, shuffle=shuffle, seed=2),
        merge_batches=merge_batches)


def _round_robin(pkg, stop_early=False, randomize=False):
    S = _ns(pkg)
    return S.RoundRobinSampler(
        S.SimpleCutSampler(_cuts(pkg, 8, "a"), max_cuts=2, shuffle=True, seed=3),
        S.SimpleCutSampler(_cuts(pkg, 14, "b"), max_duration=3.0, shuffle=True, seed=4),
        S.SimpleCutSampler(_cuts(pkg, 5, "c"), max_cuts=1),
        stop_early=stop_early, randomize=randomize, seed=7)


def _weighted(pkg, seed=0):
    cuts = _cuts(pkg, 30, "w")
    weights = [float(1 + (i * 7) % 5) for i in range(len(cuts))]
    return _ns(pkg).WeightedSimpleCutSampler(
        cuts, weights, num_samples=17, max_duration=4.0, seed=seed)


def _dynamic(pkg):
    return _ns(pkg).DynamicCutSampler(
        _cuts(pkg, 25, "d"), max_duration=4.0, shuffle=True, seed=5)


SAMPLERS = {
    "zip": _zip,
    "zip_tuples": lambda pkg: _zip(pkg, merge_batches=False),
    "zip_in_order": lambda pkg: _zip(pkg, shuffle=False),
    "round_robin": _round_robin,
    "round_robin_stop_early": lambda pkg: _round_robin(pkg, stop_early=True),
    "round_robin_random": lambda pkg: _round_robin(pkg, randomize=True),
    "round_robin_weighted": lambda pkg: _round_robin(pkg, randomize=[0.2, 0.5, 0.3]),
    "weighted_simple": _weighted,
    "dynamic": _dynamic,
}


def _make(name, pkg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # DynamicCutSampler over an eager CutSet
        return SAMPLERS[name](pkg)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_batches_equal_jax_over_two_epochs(name):
    ours, theirs = _make(name, PORT), _make(name, JAX)
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = [_ids(x) for x in ours], [_ids(x) for x in theirs]
        assert a == b and a
    assert ours.diagnostics.state_dict() == theirs.diagnostics.state_dict()


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("k", [0, 2])
def test_state_dict_equal_and_resumes_across_packages(name, k):
    ours, theirs = _make(name, PORT), _make(name, JAX)
    ours.set_epoch(1)
    theirs.set_epoch(1)
    it_ours, it_theirs = iter(ours), iter(theirs)
    for _ in range(k):
        assert _ids(next(it_ours)) == _ids(next(it_theirs))
    sd_ours, sd_theirs = ours.state_dict(), theirs.state_dict()
    assert sd_ours == sd_theirs
    rest = _drain(theirs)
    assert _drain(ours) == rest
    # Each package's checkpoint resumes in the other's fresh sampler. A
    # randomized RoundRobinSampler re-seeds its chooser with seed + epoch on
    # ``iter()``, in both packages, so its resumed order is not the rest of
    # the uninterrupted epoch; the two packages still agree.
    for state in (sd_theirs, sd_ours):
        resumed = []
        for pkg in (PORT, JAX):
            fresh = _make(name, pkg)
            fresh.load_state_dict(copy.deepcopy(state))
            resumed.append([_ids(x) for x in fresh])
        assert resumed[0] == resumed[1]
        if name not in ("round_robin_random", "round_robin_weighted") or k == 0:
            assert resumed[0] == rest, k


def test_round_robin_alternates_and_exhausts():
    """tests/test_sampler_matrix.py: strict alternation while both live,
    then the longer one drains; with ``stop_early`` it ends with the
    shorter one."""
    def rr(pkg, **kw):
        S = _ns(pkg)
        return S.RoundRobinSampler(S.SimpleCutSampler(_cuts(pkg, 4, "a", (1.0,)), max_cuts=2),
                                   S.SimpleCutSampler(_cuts(pkg, 8, "b", (1.0,)), max_cuts=2), **kw)

    origins = [b[0][0] for b in map(_ids, rr(PORT))]
    assert origins == ["a", "b", "a", "b", "b", "b"]
    assert [b[0][0] for b in map(_ids, rr(PORT, stop_early=True))] == ["a", "b", "a", "b"]
    assert [_ids(b) for b in rr(PORT)] == [_ids(b) for b in rr(JAX)]
    with pytest.raises(AssertionError, match="probabilities"):
        rr(PORT, randomize=[1.0])


def test_zip_merges_or_pairs_batches():
    """tests/test_sampler_matrix.py: one batch of each sampler per step,
    merged into one CutSet or kept as a tuple; the epoch ends with the
    shorter sampler."""
    S = PS
    merged = list(S.ZipSampler(S.SimpleCutSampler(_cuts(PORT, 6, "a"), max_cuts=2),
                               S.SimpleCutSampler(_cuts(PORT, 6, "b"), max_cuts=3)))
    assert [len(b) for b in merged] == [5, 5]
    pairs = list(S.ZipSampler(S.SimpleCutSampler(_cuts(PORT, 6, "a"), max_cuts=2),
                              S.SimpleCutSampler(_cuts(PORT, 6, "b"), max_cuts=3),
                              merge_batches=False))
    assert all(isinstance(p, tuple) and len(p) == 2 for p in pairs)
    assert all(c.id.startswith("a") for p in pairs for c in p[0])
    bad = S.ZipSampler(S.SimpleCutSampler(_cuts(PORT, 6, "a"), max_cuts=2))
    with pytest.raises(AssertionError, match="mismatch"):
        bad.load_state_dict(copy.deepcopy(_zip(PORT).state_dict()))


def test_weighted_simple_draws_without_replacement():
    """tests/test_sampler_matrix.py and tests/test_sampling.py: the epoch
    ends after ``num_samples`` draws, no cut twice, heavy weights early,
    the same draw when the epoch is repeated."""
    cuts = _cuts(PORT, 10, "w", (1.0,))
    weights = [100.0, 100.0] + [1e-6] * 8
    sampler = PS.WeightedSimpleCutSampler(cuts, weights, num_samples=8, max_cuts=4, seed=0)
    drawn = [c for b in map(_ids, sampler) for c in b]
    assert len(drawn) == len(set(drawn)) == 8
    assert {cuts[0].id, cuts[1].id} <= set(drawn[:4])
    sampler.set_epoch(0)
    assert [c for b in map(_ids, sampler) for c in b] == drawn
    with pytest.raises(AssertionError):
        PS.WeightedSimpleCutSampler(cuts, weights, num_samples=10, max_cuts=4)
    with pytest.raises(AssertionError):
        PS.WeightedDataSource(cuts, weights[:-1], num_samples=3)


@pytest.mark.parametrize("name", ["zip", "round_robin", "weighted_simple", "dynamic"])
def test_combined_samplers_pickle(name):
    """tests/test_sampler_pickling.py: a pickled sampler keeps its state
    and yields the same batches."""
    sampler = _make(name, PORT)
    restored = pickle.loads(pickle.dumps(sampler))
    assert type(restored) is type(sampler) and restored.state_dict() == sampler.state_dict()
    assert [_ids(x) for x in restored] == [_ids(x) for x in sampler]


# -- StatelessSampler ------------------------------------------------------------------------


@pytest.fixture
def manifests(tmp_path):
    """Two uncompressed JSONL manifests of dummy cuts of 1, 2 and 3 s,
    written by the JAX package."""
    paths = []
    for name, n in (("ihm", 12), ("sdm", 7)):
        cuts = J.CutSet.from_cuts(jfastcopy(c, id=f"{name}-{c.id}", duration=1.0 + i % 3)
                                  for i, c in enumerate(JDummyManifest(J.CutSet, begin_id=0, end_id=n)))
        cuts.to_file(tmp_path / f"{name}.jsonl")
        paths.append(tmp_path / f"{name}.jsonl")
    return paths


def _stateless(pkg, paths, index, seed=0, **kw):
    kw = kw or {"max_duration": 6.0}
    return _ns(pkg).StatelessSampler(
        [(paths[0], 1.0), (paths[1], 2.0)], index_path=index, base_seed=seed, **kw)


def _take(sampler, n):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [_ids(b) for b in itertools.islice(iter(sampler), n)]


@pytest.mark.parametrize("seed,kwargs", [
    (0, {"max_duration": 6.0}), (5, {"max_duration": 6.0}), (0, {"max_cuts": 3}),
    (5, {"max_cuts": 3}), (5, {"max_duration": 6.0, "num_buckets": 3, "duration_bins": [1.5, 2.5]})])
def test_stateless_equals_jax(tmp_path, manifests, seed, kwargs):
    """The same cut ids per seed, in the plain and the bucketing mode; the
    port's ``.idx`` files and summary equal the JAX package's bytes."""
    theirs = _take(_stateless(JAX, manifests, tmp_path / "j.idx", seed, **kwargs), 6)
    jidx = {p: (p.parent / (p.name + ".idx")).read_bytes() for p in manifests}
    for p in manifests:
        (p.parent / (p.name + ".idx")).unlink()
    ours = _take(_stateless(PORT, manifests, tmp_path / "p.idx", seed, **kwargs), 6)
    assert ours == theirs and len(ours) == 6
    assert {p: (p.parent / (p.name + ".idx")).read_bytes() for p in manifests} == jidx
    assert (tmp_path / "p.idx").read_text() == (tmp_path / "j.idx").read_text().replace(
        "j.idx", "p.idx")
    assert _take(_stateless(PORT, manifests, tmp_path / "p.idx", seed, **kwargs), 6) == ours


def test_stateless_seeds_ranks_and_workers(tmp_path, manifests, monkeypatch):
    """Infinite and deterministic per seed; rank 1 of two draws another
    stream (seed + 1000 · rank), as in the JAX package; no state to save."""
    a = _take(_stateless(PORT, manifests, tmp_path / "f.idx", 5), 8)
    assert len(a) == 8 and a == _take(_stateless(PORT, manifests, tmp_path / "f.idx", 5), 8)
    assert a != _take(_stateless(PORT, manifests, tmp_path / "f.idx", 6), 8)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    rank1 = _take(_stateless(PORT, manifests, tmp_path / "f.idx", 5), 8)
    assert rank1 != a
    assert rank1 == _take(_stateless(JAX, manifests, tmp_path / "f.idx", 5), 8)
    sampler = _stateless(PORT, manifests, tmp_path / "f.idx", 5)
    assert sampler.state_dict() == {} and sampler.load_state_dict({}) is None


def _mark(cuts):
    return CutSet.from_cuts(fastcopy(c, id=c.id + "-m") for c in cuts)


def test_stateless_map_wrapper_and_refusals(tmp_path, manifests):
    """tests/test_stateless_sampler_deep.py: ``map`` applies to each batch,
    ``IterableDatasetWrapper`` iterates it, a compressed manifest and a
    sampler without a limit are refused."""
    from lhotse_tpu_torch.dataset.iterable_dataset import IterableDatasetWrapper

    mapped = _stateless(PORT, manifests, tmp_path / "f.idx", 1, max_cuts=2).map(_mark)
    assert all(i.endswith("-m") for i in _take(mapped, 1)[0])

    class Ids:
        def __getitem__(self, cuts):
            return [c.id for c in cuts]

    wrapper = IterableDatasetWrapper(
        dataset=Ids(), sampler=_stateless(PORT, manifests, tmp_path / "f.idx", 3, max_cuts=4))
    got = list(itertools.islice(iter(wrapper), 5))
    assert len(got) == 5 and all(len(ids) == 4 for ids in got)
    CutSet.from_file(manifests[0]).to_file(tmp_path / "c.jsonl.gz")
    with pytest.raises(AssertionError, match="uncompressed"):
        PS.StatelessSampler([tmp_path / "c.jsonl.gz"], tmp_path / "g.idx", base_seed=0, max_cuts=2)
    with pytest.raises(AssertionError, match="max_duration or max_cuts"):
        PS.StatelessSampler(manifests, tmp_path / "h.idx", base_seed=0)


# -- the slice as a whole --------------------------------------------------------------------


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Two sources of noise utterances (``ihm``: 6 of 0.6-1.6 s; ``sdm``: 6
    of 0.5-1.2 s) with one supervision each, as JAX-written manifests."""
    root = tmp_path_factory.mktemp("combined_slice")
    rng = np.random.default_rng(17)
    for name, span in (("ihm", (0.6, 1.6)), ("sdm", (0.5, 1.2))):
        cuts = []
        for i in range(6):
            n = int(SR * rng.uniform(*span))
            x = (rng.standard_normal(n) * rng.uniform(0.02, 0.2)).astype(np.float32)
            jwrite_wav(str(root / f"{name}{i}.wav"), x[None], SR)
            cut = J.Recording.from_file(root / f"{name}{i}.wav").to_cut()
            cut.supervisions.append(J.SupervisionSegment(
                id=f"{name}-sup{i}", recording_id=cut.recording_id, start=0.0,
                duration=cut.duration, text=f"{name} {i}", speaker=f"{name}{i % 2}"))
            cuts.append(cut)
        J.CutSet.from_cuts(cuts).to_file(root / f"{name}.jsonl")
    return root


def _slice_batches(pkg, root, features=True, resume_after=None):
    """ZipSampler over the normalised ``ihm`` and the narrowbanded ``sdm``
    cuts → the three cut transforms → K2SpeechRecognitionDataset with
    OnTheFlyFeatures on the CPU (the port, ``features``) or AudioSamples.
    Returns the batches, and the sampler's and the transforms' state dicts
    after ``resume_after`` batches."""
    port = pkg == PORT
    cutset, S, T = (CutSet, PS, PT) if port else (J.CutSet, JS, JT)
    ihm = cutset.from_file(root / "ihm.jsonl").normalize_loudness(-23.0)
    sdm = cutset.from_file(root / "sdm.jsonl").narrowband("mulaw")
    sampler = S.ZipSampler(S.SimpleCutSampler(ihm, max_duration=3.0, shuffle=True, seed=0),
                           S.SimpleCutSampler(sdm, max_duration=2.5, shuffle=True, seed=1))
    transforms = [T.CutConcatenate(gap=1.0, duration_factor=2.0),
                  T.ClippingTransform(gain_db=(0.0, 12.0), p=0.5, seed=3),
                  T.LowpassUsingResampling(p=0.5, frequencies_interval=(4000, 4001), seed=4)]
    if port:
        strategy = OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))) if features else AudioSamples()
        dataset = K2SpeechRecognitionDataset(
            cut_transforms=transforms, return_cuts=True, input_strategy=strategy)
    else:
        dataset = JDataset(cut_transforms=transforms, return_cuts=True, input_strategy=JAudioSamples())
    batches, states = [], None
    (fix_random_seed if port else jfix)(0)
    for i, cuts in enumerate(sampler):
        batches.append(dataset[cuts])
        if i + 1 == resume_after:
            states = (copy.deepcopy(sampler.state_dict()),
                      [copy.deepcopy(t.state_dict()) for t in transforms[1:]])
    return batches, states


def _float64_kernel_route(layer, x):
    """The JAX fbank layer's kernel route (symmetric-padded frames through
    its folded DFT matrices, power, mel, floored log) in float64 numpy."""
    Mc, Ms, fb, n_mels = (np.asarray(m, np.float64) if i < 3 else m
                          for i, m in enumerate(layer._fused_matrices()))
    x = np.asarray(x, np.float64)
    frame, shift = 400, 160
    num_frames = (x.shape[1] + shift // 2) // shift
    need = (num_frames - 1) * shift + frame
    left = (frame - shift) // 2
    padded = np.pad(x, ((0, 0), (left, max(need - x.shape[1] - left, 0))), mode="symmetric")
    frames = padded[:, :need][:, np.arange(num_frames)[:, None] * shift + np.arange(frame)]
    power = (frames @ Mc) ** 2 + (frames @ Ms) ** 2
    return np.log(np.maximum(power @ fb[:, :n_mels], np.finfo(np.float32).eps))


def _sups(batch):
    return {k: v for k, v in batch["supervisions"].items() if k != "cut"}


def test_zip_to_cut_transforms_to_on_the_fly_features_equal_jax(sources):
    ours, states = _slice_batches(PORT, sources, resume_after=1)
    audio, _ = _slice_batches(PORT, sources, features=False)
    theirs, jstates = _slice_batches(JAX, sources, resume_after=1)
    assert len(ours) == len(theirs) == len(audio) >= 2
    assert states == jstates
    layer = jl.Wav2LogFilterBank()
    kinds = set()
    for a, x, b in zip(ours, audio, theirs):
        assert [c.to_dict() for c in a["supervisions"]["cut"]] == [
            c.to_dict() for c in b["supervisions"]["cut"]]
        assert np.array_equal(x["inputs"], b["inputs"])
        assert {k: list(map(str, v)) for k, v in _sups(x).items()} == {
            k: list(map(str, v)) for k, v in _sups(b).items()}
        # Frames on the features' side, samples on the audio's: the rest equal.
        sa, sb = _sups(a), _sups(b)
        assert set(sa) - {"start_frame", "num_frames"} == set(sb) - {"start_sample", "num_samples"}
        assert {k: list(map(str, sa[k])) for k in set(sa) & set(sb)} == {
            k: list(map(str, sb[k])) for k in set(sa) & set(sb)}
        # One row per cut; a concatenated cut carries several supervisions.
        rows = dict(zip(sb["sequence_idx"], b["supervisions"]["cut"]))
        for row, cut in rows.items():
            want = _float64_kernel_route(layer, b["inputs"][row:row + 1, :cut.num_samples])[0]
            assert want.shape[0] <= a["inputs"].shape[1]
            np.testing.assert_allclose(a["inputs"][row, :want.shape[0]], want, rtol=0,
                                       atol=FEATURE_TOL)
            kinds.add(type(cut).__name__)
            kinds.update(tag for tag in ("_ln", "_nb_mulaw", "_cl", "_lowpassed")
                         if tag in str(cut.to_dict()))
    # Every transform of the slice acted on some batch.
    assert {"MixedCut", "_ln", "_nb_mulaw", "_cl", "_lowpassed"} <= kinds
