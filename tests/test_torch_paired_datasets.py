"""
The port's paired-cut path (lhotse_tpu_torch.dataset: ``CutPairsSampler``,
``K2Speech2TextTranslationDataset``, the source separation datasets, and
``compute_and_store_features_batch`` over ``MixedCut``s) against the JAX
package's on the same manifests.

``CutPairsSampler``: the same cut ids per batch on both sides, in order,
over two epochs; the same state dict after k batches, loaded by the other
package's fresh sampler with the same rest of the epoch. Translation
batches: supervisions exactly (``text``, ``tgt_text``, the frame intervals,
the word alignments in frames, the cuts), audio exactly, stored features
exactly (both packages read one JAX-written archive), and features
extracted on the fly within ``EXTRACTOR_TOL`` of the JAX extractors' device
route (XLA on the CPU). Separation items: sources, mixture, ``real_mask``
and ``binary_mask`` ``np.array_equal`` on one JAX-written archive.

The slice as a whole: a corpus written as SPHERE (source side) and AIFF
(target side) → ``RecordingSet.from_dir`` → ``CutPairsSampler`` →
``K2Speech2TextTranslationDataset`` with ``OnTheFlyFeatures``, through both
packages. Every input is written into the test's temporary directory from
numpy arrays made from a seed.
"""
import copy
import pickle
import warnings

import numpy as np
import pytest

import lhotse_tpu as J
import lhotse_tpu.dataset.sampling as JS
from lhotse_tpu.audio.aiffio import write_aiff as jwrite_aiff
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.audio.sphio import write_sph as jwrite_sph
from lhotse_tpu.dataset import source_separation as jsep
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.input_strategies import PrecomputedFeatures as JPrecomputed
from lhotse_tpu.dataset.speech_translation import K2Speech2TextTranslationDataset as JTranslation
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import librispeech as jlibrispeech
from lhotse_tpu.testing.dummies import DummyManifest as JDummyManifest
from lhotse_tpu.utils import fastcopy as jfastcopy
import lhotse_tpu_torch.dataset.sampling as PS
from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet, MixedCut
from lhotse_tpu_torch.dataset import (
    CutPairsSampler, DynamicallyMixedSourceSeparationDataset, K2Speech2TextTranslationDataset,
    PreMixedSourceSeparationDataset, SourceSeparationDataset)
from lhotse_tpu_torch.dataset.input_strategies import (
    AudioSamples, OnTheFlyFeatures, PrecomputedFeatures)
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.features.io import NumpyFilesWriter
from lhotse_tpu_torch.recipes import librispeech as plibrispeech
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.testing.dummies import DummyManifest
from lhotse_tpu_torch.utils import fastcopy
from test_torch_recipes import librispeech_root  # noqa: F401  (a fixture)

SR = 16000
# The extractor's bound against the JAX device route (tests/test_torch_precomputed.py).
EXTRACTOR_TOL = 3e-4
PORT, JAX = "port", "jax"


# -- CutPairsSampler --------------------------------------------------------------------


def _cuts(pkg, n, durations, prefix=""):
    manifest, cutset, copy_ = ((DummyManifest, CutSet, fastcopy) if pkg == PORT
                               else (JDummyManifest, J.CutSet, jfastcopy))
    cuts = manifest(cutset, begin_id=0, end_id=n)
    return cutset.from_cuts(
        copy_(c, id=f"{prefix}{c.id}", duration=durations[i % len(durations)])
        for i, c in enumerate(cuts))


def _pairs(pkg, n=23, **kw):
    """Sources of 1-2.5 s and targets of twice their length (as translation
    pairs), same ids."""
    src = _cuts(pkg, n, (1.0, 1.5, 2.5, 0.5, 2.0))
    tgt = _cuts(pkg, n, (2.0, 3.0, 5.0, 1.0, 4.0))
    return (PS if pkg == PORT else JS).CutPairsSampler(src, tgt, **kw)


CONFIGS = {
    "source_duration": dict(max_source_duration=4.0),
    "target_duration": dict(max_target_duration=7.0),
    "both_durations": dict(max_source_duration=5.0, max_target_duration=6.0),
    "max_cuts": dict(max_cuts=3),
    "shuffled": dict(max_source_duration=4.0, shuffle=True, seed=3),
    "drop_last": dict(max_source_duration=4.5, drop_last=True),
    "shuffled_drop_last": dict(max_cuts=4, shuffle=True, seed=1, drop_last=True),
    "oversized_first": dict(max_source_duration=0.7),
}


def _ids(batch):
    return tuple([c.id for c in side] for side in batch)


def _drain(sampler):
    out = []
    while True:
        try:
            out.append(_ids(next(sampler)))
        except StopIteration:
            return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pairs_equal_jax_over_two_epochs(name):
    ours, theirs = _pairs(PORT, **CONFIGS[name]), _pairs(JAX, **CONFIGS[name])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = [_ids(b) for b in ours], [_ids(b) for b in theirs]
            assert got == want and got
            assert all(s == t for s, t in got)
    assert ours.diagnostics.state_dict() == theirs.diagnostics.state_dict()


@pytest.mark.parametrize("name", ["both_durations", "shuffled", "max_cuts"])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_state_dict_equal_and_resumes_across_packages(name, k):
    ours, theirs = _pairs(PORT, **CONFIGS[name]), _pairs(JAX, **CONFIGS[name])
    ours.set_epoch(1)
    theirs.set_epoch(1)
    it_ours, it_theirs = iter(ours), iter(theirs)
    for _ in range(k):
        assert _ids(next(it_ours)) == _ids(next(it_theirs))
    sd_ours, sd_theirs = ours.state_dict(), theirs.state_dict()
    assert sd_ours == sd_theirs
    assert "source_constraints" in sd_ours and "target_constraints" in sd_ours
    rest = _drain(theirs)
    assert _drain(ours) == rest
    for state in (sd_theirs, sd_ours):
        for pkg in (PORT, JAX):
            fresh = _pairs(pkg, **CONFIGS[name])
            fresh.load_state_dict(copy.deepcopy(state))
            assert [_ids(b) for b in fresh] == rest


def test_state_dict_overwrites_other_constraints_with_a_warning():
    sampler = _pairs(PORT, max_source_duration=4.0)
    state = _pairs(JAX, max_source_duration=6.0).state_dict()
    with pytest.warns(UserWarning, match="Inconsistent source_constraint"):
        sampler.load_state_dict(copy.deepcopy(state))
    assert sampler.source_constraints.max_duration == 6.0


def test_pairs_stay_aligned_and_keep_their_sides():
    src = _cuts(PORT, 9, (1.0,))
    tgt = CutSet.from_cuts(fastcopy(c, duration=0.5) for c in src)
    for s_batch, t_batch in CutPairsSampler(src, tgt, max_cuts=4):
        assert [c.id for c in s_batch] == [c.id for c in t_batch]
        assert all(t.duration == 0.5 for t in t_batch)


def test_source_duration_budget():
    src = _cuts(PORT, 10, (2.0,))
    tgt = CutSet.from_cuts(fastcopy(c, duration=0.1) for c in src)
    sizes = [len(s) for s, _ in CutPairsSampler(src, tgt, max_source_duration=6.0)]
    assert sizes == [3, 3, 3, 1]


@pytest.mark.parametrize("pkg", [PORT, JAX])
def test_differing_ids_raise(pkg):
    sampler = (PS if pkg == PORT else JS).CutPairsSampler(
        _cuts(pkg, 4, (1.0,)), _cuts(pkg, 4, (1.0,), prefix="other-"), max_cuts=2)
    with pytest.raises(AssertionError, match="differing IDs"):
        list(sampler)


def test_ranks_partition_and_filter_equal_jax():
    for rank in (0, 1):
        got = [_ids(b) for b in _pairs(PORT, max_cuts=2, world_size=2, rank=rank)]
        want = [_ids(b) for b in _pairs(JAX, max_cuts=2, world_size=2, rank=rank)]
        assert got == want and got
    ours, theirs = _pairs(PORT, max_cuts=3), _pairs(JAX, max_cuts=3)
    ours.filter(lambda c: c.duration > 1.0)
    theirs.filter(lambda c: c.duration > 1.0)
    assert [_ids(b) for b in ours] == [_ids(b) for b in theirs]
    assert ours.diagnostics.state_dict() == theirs.diagnostics.state_dict()


def test_pickles_with_identical_batches():
    sampler = _pairs(PORT, max_source_duration=4.0, shuffle=True)
    restored = pickle.loads(pickle.dumps(sampler))
    assert type(restored) is CutPairsSampler and restored.state_dict() == sampler.state_dict()
    assert [_ids(b) for b in restored] == [_ids(b) for b in sampler]


# -- K2Speech2TextTranslationDataset ---------------------------------------------------------


def _translated(text: str) -> str:
    """A made-up translation: the words reversed, each spelled backwards."""
    return " ".join(w[::-1] for w in reversed(text.split()))


def _libri_cuts(pkg, root, workdir):
    """The recipe's cuts, each supervision with a ``translated_text``."""
    prepare, CS, copy_ = ((plibrispeech.prepare_librispeech, CutSet, fastcopy) if pkg == PORT
                          else (jlibrispeech.prepare_librispeech, J.CutSet, jfastcopy))
    manifests = prepare(root, output_dir=workdir / pkg)
    cuts = []
    for part in sorted(manifests):
        for cut in CS.from_manifests(**manifests[part]):
            cuts.append(copy_(cut, supervisions=[
                copy_(s, custom={"translated_text": _translated(s.text)}) for s in cut.supervisions]))
    return CS.from_cuts(cuts)


def _of_recordings(cuts, recording_ids):
    return cuts.filter(lambda c: c.recording_id in recording_ids).to_eager()


def _same_supervisions(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "cut":
            assert [c.to_dict() for c in got[key]] == [c.to_dict() for c in value]
        elif isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value)
            assert got[key].dtype == value.dtype
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("strategy", ["on_the_fly", "audio", "precomputed"])
def test_translation_batches_equal_jax(librispeech_root, tmp_path, strategy):  # noqa: F811
    ours_cuts = _libri_cuts(PORT, librispeech_root, tmp_path)
    theirs_cuts = _libri_cuts(JAX, librispeech_root, tmp_path)
    assert [c.to_dict() for c in ours_cuts] == [c.to_dict() for c in theirs_cuts]
    if strategy == "on_the_fly":
        ours = K2Speech2TextTranslationDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
        theirs = JTranslation(
            return_cuts=True, input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))))
    elif strategy == "audio":
        ours = K2Speech2TextTranslationDataset(return_cuts=True, input_strategy=AudioSamples())
        theirs = JTranslation(return_cuts=True, input_strategy=JAudioSamples())
    else:
        featured = theirs_cuts.compute_and_store_features(
            JFbank(), tmp_path / "feats", storage_type=J.LilcomChunkyWriter, progress_bar=False)
        featured.to_file(tmp_path / "featured.jsonl")
        theirs_cuts = J.CutSet.from_file(tmp_path / "featured.jsonl")
        ours_cuts = CutSet.from_file(tmp_path / "featured.jsonl")
        ours = K2Speech2TextTranslationDataset(return_cuts=True, input_strategy=PrecomputedFeatures())
        theirs = JTranslation(return_cuts=True, input_strategy=JPrecomputed())
    # Audio carries no frame shift, so the one utterance with word
    # alignments is batched through the feature strategies only.
    subsets = [None, ["84-121123-0001", "174-50561-0000"]]
    if strategy != "audio":
        subsets.append(["84-121123-0000"])
    batches = 0
    for ids in subsets:
        o = ours_cuts if ids is None else _of_recordings(ours_cuts, ids)
        t = theirs_cuts if ids is None else _of_recordings(theirs_cuts, ids)
        got, want = ours[o], theirs[t]
        _same_supervisions(got["supervisions"], want["supervisions"])
        assert got["supervisions"]["tgt_text"] == [_translated(x) for x in got["supervisions"]["text"]]
        if strategy == "on_the_fly":
            assert got["inputs"].shape == want["inputs"].shape and np.isfinite(got["inputs"]).all()
            np.testing.assert_allclose(got["inputs"], want["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        else:
            np.testing.assert_array_equal(got["inputs"], want["inputs"])
        batches += 1
        if ids == ["84-121123-0000"]:
            # The one utterance with word alignments: words and their frames.
            sups = got["supervisions"]
            assert sups["word"] == [["HELLO", "WORLD", "NUMBER", "0000"]]
            assert sups["word_start"] == [[0, 25, 50, 75]]
    assert batches == len(subsets)


def test_translation_word_frames_need_a_frame_shift(librispeech_root, tmp_path):  # noqa: F811
    """Audio inputs carry no frame shift: word alignments raise in both packages."""
    cuts = _of_recordings(_libri_cuts(PORT, librispeech_root, tmp_path), ["84-121123-0000"])
    jcuts = _of_recordings(_libri_cuts(JAX, librispeech_root, tmp_path), ["84-121123-0000"])
    with pytest.raises(ValueError, match="frame_shift"):
        K2Speech2TextTranslationDataset(input_strategy=AudioSamples())[cuts]
    with pytest.raises(ValueError, match="frame_shift"):
        JTranslation(input_strategy=JAudioSamples())[jcuts]


# -- source separation -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def separation(tmp_path_factory):
    """Four utterances of seeded noise (two pairs, each pair cut to one
    length), written as FLAC; the sources' features and the pre-mixed
    mixtures' features stored by the JAX package in one ``lilcom_chunky``
    archive each; the manifests as JSONL."""
    root = tmp_path_factory.mktemp("separation")
    rng = np.random.default_rng(11)
    cuts = []
    for i, seconds in enumerate((1.3, 1.1, 0.9, 1.2)):
        path = root / f"spk{i}.flac"
        jwrite_flac(str(path), (0.1 * rng.standard_normal(int(SR * seconds))).astype(np.float32), SR)
        cuts.append(J.Recording.from_file(path).to_cut())
    pairs = [(0, 1), (2, 3)]
    sources = []
    for a, b in pairs:
        length = min(cuts[a].duration, cuts[b].duration)
        sources += [cuts[a].truncate(duration=length), cuts[b].truncate(duration=length)]
    sources = J.CutSet.from_cuts(sources)
    sources.to_file(root / "sources_audio.jsonl")
    featured = sources.compute_and_store_features(
        JFbank(), root / "source_feats", storage_type=J.LilcomChunkyWriter, progress_bar=False)
    featured.to_file(root / "sources.jsonl")
    return root


def _mixtures(pkg, root, featured: bool):
    """The pairs mixed at 5 dB, each as a ``MixedCut`` named ``mix-<i>``,
    of the featured or the audio source cuts."""
    CS, copy_ = (CutSet, fastcopy) if pkg == PORT else (J.CutSet, jfastcopy)
    src = list(CS.from_file(root / ("sources.jsonl" if featured else "sources_audio.jsonl")))
    return CS.from_cuts(
        copy_(src[2 * i].mix(src[2 * i + 1], snr=5.0), id=f"mix-{i}") for i in range(len(src) // 2))


def _premixed(pkg, root):
    """The pre-mixed layout: mixtures flattened into feature-only cuts by
    the JAX package's ``compute_and_store_features_batch``, and the sources
    under each mixture's recording id (one recording per mixture)."""
    if not (root / "mixtures.jsonl").exists():
        _mixtures(JAX, root, featured=False).compute_and_store_features_batch(
            JFbank(), root / "mixture_feats", manifest_path=root / "mixtures.jsonl",
            storage_type=J.LilcomChunkyWriter)
    CS, copy_ = (CutSet, fastcopy) if pkg == PORT else (J.CutSet, jfastcopy)
    src = list(CS.from_file(root / "sources.jsonl"))
    relabelled = [
        copy_(c, id=f"mix-{i // 2}-src{i % 2}", recording=None,
              features=copy_(c.features, recording_id=f"mix-{i // 2}"))
        for i, c in enumerate(src)]
    return CS.from_cuts(relabelled), CS.from_file(root / "mixtures.jsonl").to_eager()


def _same_items(ours, theirs):
    assert len(ours) == len(theirs) == 2
    for i in range(len(theirs)):
        got, want = ours[i], theirs[i]
        assert set(got) == set(want) == {"sources", "mixture", "real_mask", "binary_mask"}
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == want[key].dtype
        assert got["sources"].shape[0] == 2
        np.testing.assert_allclose(got["real_mask"].sum(0), 1.0, rtol=0, atol=1e-6)
        assert set(np.unique(got["binary_mask"])) <= {0, 1}


def test_dynamically_mixed_equals_jax(separation):
    with pytest.warns(UserWarning, match="not yet updated"):
        ours = DynamicallyMixedSourceSeparationDataset(
            CutSet.from_file(separation / "sources.jsonl").to_eager(),
            _mixtures(PORT, separation, featured=True))
    with pytest.warns(UserWarning):
        theirs = jsep.DynamicallyMixedSourceSeparationDataset(
            J.CutSet.from_file(separation / "sources.jsonl").to_eager(),
            _mixtures(JAX, separation, featured=True))
    _same_items(ours, theirs)
    assert all(isinstance(c, MixedCut) for c in ours.mixtures_set)


def test_validate_walks_the_mixtures(separation):
    """The port's ``validate`` checks each ``MixedCut``'s sources; the JAX
    base class calls ``.values()`` on the ``mixed_cuts`` ``CutSet`` and
    raises ``AttributeError`` (ROADMAP C1). Without a non-sources set both
    packages then refuse ``validate(None)``, as the reference does."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sources = CutSet.from_file(separation / "sources.jsonl").to_eager()
        noise = CutSet.from_cuts([list(sources)[0]])
        ours = DynamicallyMixedSourceSeparationDataset(
            sources, _mixtures(PORT, separation, featured=True), nonsources_set=noise)
        jsources = J.CutSet.from_file(separation / "sources.jsonl").to_eager()
        theirs = jsep.DynamicallyMixedSourceSeparationDataset(
            jsources, _mixtures(JAX, separation, featured=True),
            nonsources_set=J.CutSet.from_cuts([list(jsources)[0]]))
        assert ours.validate() is None
        with pytest.raises(AttributeError, match="values"):
            theirs.validate()
        ours.nonsources_set = None
        with pytest.raises(ValueError, match="unknown type"):
            ours.validate()
        premixed = PreMixedSourceSeparationDataset(*_premixed(PORT, separation))
        assert premixed.validate() is None
        with pytest.raises(AttributeError, match="values"):
            jsep.PreMixedSourceSeparationDataset(*_premixed(JAX, separation)).validate()


def test_premixed_equals_jax(separation):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = PreMixedSourceSeparationDataset(*_premixed(PORT, separation))
        theirs = jsep.PreMixedSourceSeparationDataset(*_premixed(JAX, separation))
    assert ours.mixture_to_source == theirs.mixture_to_source == {
        "mix-0": ["mix-0-src0", "mix-0-src1"], "mix-1": ["mix-1-src0", "mix-1-src1"]}
    _same_items(ours, theirs)


def test_base_class_refuses_to_mix(separation):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = SourceSeparationDataset(*_premixed(PORT, separation))
        theirs = jsep.SourceSeparationDataset(*_premixed(JAX, separation))
    for dataset in (ours, theirs):
        assert len(dataset) == 2
        with pytest.raises(NotImplementedError, match="abstract base"):
            dataset[0]


def test_batch_extraction_flattens_mixed_cuts_as_jax(separation, tmp_path):
    """``compute_and_store_features_batch`` over ``MixedCut``s: each mix
    becomes a feature-only ``MonoCut`` under its own id, the manifest the JAX
    package writes; the features within ``EXTRACTOR_TOL`` of the JAX device
    route's."""
    ours = _mixtures(PORT, separation, featured=False).compute_and_store_features_batch(
        Fbank(FbankConfig(device="cpu")), tmp_path / "ours", manifest_path=tmp_path / "ours.jsonl",
        storage_type=NumpyFilesWriter).to_eager()
    theirs = _mixtures(JAX, separation, featured=False).compute_and_store_features_batch(
        JFbank(JFbankConfig(device="tpu")), tmp_path / "jax", manifest_path=tmp_path / "jax.jsonl",
        storage_type=J.NumpyFilesWriter).to_eager()

    def portable(cut):
        d = cut.to_dict()
        d["features"] = {k: v for k, v in d["features"].items() if k not in ("storage_path", "type")}
        return d

    assert [portable(c) for c in ours] == [portable(c) for c in theirs]
    for got, want in zip(ours, theirs):
        assert got.recording_id == got.id and not got.has_recording
        np.testing.assert_allclose(got.load_features(), want.load_features(), rtol=0, atol=EXTRACTOR_TOL)


# -- the slice as a whole ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def paired_corpus(tmp_path_factory):
    """Six utterances of seeded noise, 0.8-2.0 s: the source side as SPHERE
    (pcm16 and ulaw in turn), the target side as AIFF, both written by the
    JAX package's writers under the same stems; a supervision per
    utterance with a text and its ``translated_text``."""
    root = tmp_path_factory.mktemp("paired")
    (root / "src").mkdir()
    (root / "tgt").mkdir()
    rng = np.random.default_rng(21)
    words = ("ALPHA", "BRAVO", "CHARLIE", "DELTA")
    texts = {}
    for i in range(6):
        x = (0.1 * rng.standard_normal(int(SR * rng.uniform(0.8, 2.0)))).astype(np.float32)
        jwrite_sph(root / "src" / f"utt{i}.sph", x, SR, coding=("pcm16", "ulaw")[i % 2])
        jwrite_aiff(root / "tgt" / f"utt{i}.aiff", x, SR)
        texts[f"utt{i}"] = " ".join(words[j] for j in rng.integers(0, 4, 3))
    return root, texts


def _paired_cuts(pkg, root, texts, side, pattern):
    RS, SS, SEG, CS = ((RecordingSet, SupervisionSet, SupervisionSegment, CutSet) if pkg == PORT
                       else (J.RecordingSet, J.SupervisionSet, J.SupervisionSegment, J.CutSet))
    recordings = RS.from_recordings(sorted(RS.from_dir(root / side, pattern), key=lambda r: r.id))
    supervisions = SS.from_segments(
        SEG(id=f"{r.id}-sup", recording_id=r.id, start=0.0, duration=r.duration, channel=0,
            text=texts[r.id], custom={"translated_text": _translated(texts[r.id])})
        for r in recordings)
    return CS.from_manifests(recordings, supervisions)


def _slice(pkg, root, texts):
    src = _paired_cuts(pkg, root, texts, "src", "*.sph")
    tgt = _paired_cuts(pkg, root, texts, "tgt", "*.aiff")
    if pkg == PORT:
        sampler = CutPairsSampler(src, tgt, max_source_duration=3.0, max_target_duration=3.5,
                                  shuffle=True, seed=0)
        dataset = K2Speech2TextTranslationDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    else:
        sampler = JS.CutPairsSampler(src, tgt, max_source_duration=3.0, max_target_duration=3.5,
                                     shuffle=True, seed=0)
        dataset = JTranslation(
            return_cuts=True, input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))))
    return [(dataset[s], dataset[t]) for s, t in sampler]


def test_sphere_pairs_to_translation_features_equal_jax(paired_corpus):
    root, texts = paired_corpus
    ours, theirs = _slice(PORT, root, texts), _slice(JAX, root, texts)
    assert len(ours) == len(theirs) >= 3
    seen = []
    for (src, tgt), (jsrc, jtgt) in zip(ours, theirs):
        for got, want in ((src, jsrc), (tgt, jtgt)):
            ids = [c.id for c in got["supervisions"]["cut"]]
            assert ids == [c.id for c in want["supervisions"]["cut"]]
            assert got["supervisions"]["tgt_text"] == want["supervisions"]["tgt_text"]
            assert got["supervisions"]["text"] == want["supervisions"]["text"]
            assert got["inputs"].shape == want["inputs"].shape and np.isfinite(got["inputs"]).all()
            np.testing.assert_allclose(got["inputs"], want["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        assert [c.id for c in src["supervisions"]["cut"]] == [c.id for c in tgt["supervisions"]["cut"]]
        seen += [c.recording_id for c in src["supervisions"]["cut"]]
        # The pcm16 SPHERE source and its AIFF target carry the same samples.
        for i, (s_cut, t_cut) in enumerate(zip(src["supervisions"]["cut"], tgt["supervisions"]["cut"])):
            if int(s_cut.recording_id[3:]) % 2 == 0:
                np.testing.assert_array_equal(s_cut.load_audio(), t_cut.load_audio())
                np.testing.assert_array_equal(src["inputs"][i], tgt["inputs"][i])
    assert sorted(seen) == sorted(texts)
