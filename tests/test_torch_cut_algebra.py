"""
The port's cut algebra of the recipe path (lhotse_tpu_torch.cut.set,
cut/base.py, cut/data.py, cut/mono.py, cut/mixed.py and cut/describe.py):
``CutSet.from_manifests`` eager and lazy, the trimming and windowing
operations, supervision indexes, masks and merging, ``describe`` and the
global feature statistics, against the JAX package's on the same manifests.

Both packages number new cuts with ``uuid4()`` and draw random context with
``random``; each side runs after ``fix_random_seed(0)`` in its own package,
so the cuts come out equal id for id. The manifests, the audio and the
stored features are written once, by the JAX package, and read by both.
"""
import dataclasses
import gzip
import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.cut import describe as jdescribe
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.testing.dummies import dummy_multi_channel_recording
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet, MixedCut, MonoCut
from lhotse_tpu_torch.cut import describe as pdescribe
from lhotse_tpu_torch.features import FeatureSet
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import compute_num_frames, fix_random_seed

SR = 16000
# Global feature statistics: the same stored matrices, accumulated in the
# same float64 order on both sides.
STATS_TOL = 1e-6

PORT = SimpleNamespace(
    RecordingSet=RecordingSet, SupervisionSet=SupervisionSet, FeatureSet=FeatureSet,
    CutSet=CutSet, seed=fix_random_seed, describe=pdescribe)
JAX = SimpleNamespace(
    RecordingSet=J.RecordingSet, SupervisionSet=J.SupervisionSet, FeatureSet=J.FeatureSet,
    CutSet=J.CutSet, seed=jfix, describe=jdescribe)


def _dicts(manifest) -> list:
    return [item.to_dict() for item in manifest]


def _both(build):
    """``build(ns)`` for the port and for JAX, each after seeding its package."""
    PORT.seed(0)
    ours = build(PORT)
    JAX.seed(0)
    theirs = build(JAX)
    return ours, theirs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three FLAC recordings (4.0, 3.0 and 2.5 s) with six supervisions on
    the first two (an overlapping pair, word alignments, two speakers) and
    none on the third, written by the JAX package as sorted ``.jsonl.gz``
    manifests, plus a ``lilcom_chunky`` archive of their fbank features and
    its FeatureSet."""
    root = tmp_path_factory.mktemp("cut_algebra")
    rng = np.random.default_rng(9)
    recs = []
    for i, seconds in enumerate([4.0, 3.0, 2.5]):
        n = int(SR * seconds)
        t = np.arange(n) / SR
        x = 0.2 * np.sin(2 * np.pi * (100 + 40 * i) * t) + 0.02 * rng.standard_normal(n)
        path = root / f"rec{i}.flac"
        jwrite_flac(str(path), x.astype(np.float32), SR)
        recs.append(J.Recording.from_file(path))
    word = J.AlignmentItem
    sups = [
        ("s0", "rec0", 0.2, 1.2, "spk-a", "one two", [word("one", 0.2, 0.5), word("two", 0.9, 0.5)]),
        ("s1", "rec0", 1.0, 1.2, "spk-b", "overlap", None),
        ("s2", "rec0", 2.6, 1.3, "spk-a", "three four five",
         [word("three", 2.6, 0.3), word("four", 2.95, 0.35), word("five", 3.6, 0.3)]),
        ("s3", "rec1", 0.5, 2.0, "spk-b", "six seven",
         [word("six", 0.5, 0.6), word("seven", 1.5, 1.0)]),
        ("s4", "rec1", 2.6, 0.35, "spk-a", "eight", None),
        ("s5", "rec1", 0.0, 0.3, "spk-a", "zero", None),
    ]
    segments = [
        J.SupervisionSegment(
            id=i, recording_id=r, start=s, duration=d, channel=0, speaker=spk, text=text,
            language="English", alignment=None if ali is None else {"word": ali})
        for i, r, s, d, spk, text, ali in sups]
    segments.sort(key=lambda s: s.recording_id)
    J.RecordingSet.from_recordings(recs).to_file(root / "recordings.jsonl.gz")
    J.SupervisionSet.from_segments(segments).to_file(root / "supervisions.jsonl.gz")
    cuts = J.CutSet.from_manifests(
        recordings=J.RecordingSet.from_recordings(recs)).compute_and_store_features(
        JFbank(JFbankConfig()), root / "feats", num_jobs=1, progress_bar=False)
    J.FeatureSet.from_features(
        dataclasses.replace(c.features, recording_id=c.recording_id) for c in cuts
    ).to_file(root / "features.jsonl.gz")
    return root


def _load(ns, corpus, features=False):
    out = dict(
        recordings=ns.RecordingSet.from_file(corpus / "recordings.jsonl.gz").to_eager(),
        supervisions=ns.SupervisionSet.from_file(corpus / "supervisions.jsonl.gz").to_eager())
    if features:
        out["features"] = ns.FeatureSet.from_file(corpus / "features.jsonl.gz").to_eager()
    return out


def _cuts(ns, corpus, features=False):
    return ns.CutSet.from_manifests(**_load(ns, corpus, features))


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("features", [False, True])
@pytest.mark.parametrize("random_ids", [False, True])
def test_from_manifests(corpus, tmp_path, lazy, features, random_ids):
    def build(ns):
        manifests = {
            k: ns_cls.from_jsonl_lazy(corpus / f"{k}.jsonl.gz") if lazy else ns_cls.from_file(
                corpus / f"{k}.jsonl.gz").to_eager()
            for k, ns_cls in [("recordings", ns.RecordingSet), ("supervisions", ns.SupervisionSet),
                              ("features", ns.FeatureSet)] if k != "features" or features}
        out = tmp_path / f"{'port' if ns is PORT else 'jax'}.jsonl.gz"
        cuts = ns.CutSet.from_manifests(
            **manifests, random_ids=random_ids, lazy=lazy, output_path=out)
        return cuts, out

    (ours, ours_path), (theirs, theirs_path) = _both(build)
    assert ours.is_lazy == lazy
    assert _dicts(ours) == _dicts(theirs)
    assert [len(c.supervisions) for c in ours] == [3, 3, 0]
    assert all(isinstance(c, MonoCut) and c.has_features == features for c in ours)
    assert gzip.decompress(ours_path.read_bytes()) == gzip.decompress(theirs_path.read_bytes())


def test_from_manifests_warns_on_unsorted_lazy_inputs(corpus, tmp_path):
    recs = RecordingSet.from_file(corpus / "recordings.jsonl.gz").to_eager()
    RecordingSet(list(reversed(list(recs)))).to_file(tmp_path / "reversed.jsonl.gz")
    with pytest.warns(UserWarning, match="not attached"):
        CutSet.from_manifests(
            recordings=RecordingSet.from_jsonl_lazy(tmp_path / "reversed.jsonl.gz"),
            supervisions=SupervisionSet.from_jsonl_lazy(corpus / "supervisions.jsonl.gz"),
            output_path=tmp_path / "cuts.jsonl.gz", lazy=True)
    with pytest.raises(AssertionError, match="output_path"):
        CutSet.from_manifests(recordings=recs, lazy=True)


def test_multi_channel_input_is_not_ported(corpus):
    """Multi-channel recordings and feature manifests become MultiCuts, as
    in the JAX package (MultiCut is ported)."""
    jstereo = dummy_multi_channel_recording(0)
    stereo = Recording.from_dict(jstereo.to_dict())
    ours = CutSet.from_manifests(recordings=RecordingSet([stereo]))
    theirs = J.CutSet.from_manifests(recordings=J.RecordingSet([jstereo]))
    assert [type(c).__name__ for c in ours] == ["MultiCut"]
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    feats = FeatureSet.from_file(corpus / "features.jsonl.gz").to_eager()
    two = FeatureSet.from_features([f.copy_with(channels=[0, 1]) for f in feats])
    jtwo = J.FeatureSet.from_features([
        f.copy_with(channels=[0, 1])
        for f in J.FeatureSet.from_file(corpus / "features.jsonl.gz").to_eager()])
    fix_random_seed(0)
    ours = CutSet.from_manifests(features=two)
    jfix(0)
    theirs = J.CutSet.from_manifests(features=jtwo)
    assert {type(c).__name__ for c in ours} == {"MultiCut"}
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]


def _source(ns, corpus, kind):
    """The cuts an operation runs on: whole recordings, featured whole
    recordings, or featured MixedCuts (each recording mixed with the third
    one)."""
    cuts = _cuts(ns, corpus, features=kind != "mono")
    if kind != "mixed":
        return cuts
    cuts = list(cuts)
    return ns.CutSet.from_cuts(
        [cuts[0].mix(cuts[2], offset_other_by=1.0, snr=10), cuts[1].mix(cuts[2], snr=5)])


@pytest.mark.parametrize("kind", ["mono", "featured", "mixed"])
@pytest.mark.parametrize("kwargs", [
    dict(), dict(keep_overlapping=False), dict(min_duration=2.0),
    dict(min_duration=2.0, context_direction="left", keep_overlapping=False),
    dict(min_duration=1.5, context_direction="right"),
    dict(min_duration=2.5, context_direction="random"), dict(keep_all_channels=True)])
def test_trim_to_supervisions(corpus, kind, kwargs):
    def build(ns):
        trimmed = _source(ns, corpus, kind).trim_to_supervisions(**kwargs)
        # Evaluated here: random context draws from the package's seeded RNG.
        return trimmed.is_lazy, _dicts(trimmed)

    (lazy, ours), (_, theirs) = _both(build)
    assert lazy
    assert ours == theirs
    assert len(ours) == 6
    if kwargs.get("keep_overlapping") is False:
        assert all(len(c["supervisions"]) == 1 for c in ours if "supervisions" in c)


def test_trim_to_supervisions_fanned_out(corpus):
    """Two spawned processes give the lazy single-process result."""
    cuts = _cuts(PORT, corpus)
    assert _dicts(cuts.trim_to_supervisions(keep_overlapping=False, num_jobs=2)) == _dicts(
        cuts.trim_to_supervisions(keep_overlapping=False))


def test_trimmed_features_are_slices_of_the_parent(corpus):
    """A trimmed cut reads part of the archive: its features equal the
    frames of the whole recording's matrix at the same offsets, and the JAX
    package's partial read of the same bytes."""
    parents = {c.recording_id: c for c in _cuts(PORT, corpus, features=True)}
    jparents = {c.recording_id: c for c in _cuts(JAX, corpus, features=True)}
    trimmed = parents["rec0"].trim_to_supervisions(keep_overlapping=False)
    jtrimmed = jparents["rec0"].trim_to_supervisions(keep_overlapping=False)
    for cut, jcut in zip(trimmed, jtrimmed):
        full = parents[cut.recording_id].load_features()
        left = compute_num_frames(cut.start, frame_shift=cut.frame_shift, sampling_rate=SR)
        feats = cut.load_features()
        assert feats.shape == (cut.num_frames, 80)
        np.testing.assert_array_equal(feats, full[left: left + cut.num_frames])
        np.testing.assert_array_equal(feats, jcut.load_features())


@pytest.mark.parametrize("kind", ["mono", "mixed"])
@pytest.mark.parametrize("op", [
    lambda c: c.trim_to_alignments("word"), lambda c: c.trim_to_alignments("word", max_pause=0.5),
    lambda c: c.trim_to_alignments("word", max_pause=1.0, max_segment_duration=1.2, delimiter="|"),
    lambda c: c.trim_to_supervision_groups(), lambda c: c.trim_to_supervision_groups(max_pause=0.5),
    lambda c: c.cut_into_windows(1.0), lambda c: c.cut_into_windows(1.5, hop=0.75),
    lambda c: c.cut_into_windows(1.0, keep_excessive_supervisions=False),
    lambda c: c.cut_into_windows_balanced(1.0, 2.0, overlap=0.25),
    lambda c: c.trim_to_unsupervised_segments(), lambda c: c.merge_supervisions(),
    lambda c: c.merge_supervisions(merge_policy="keep_first"),
    lambda c: c.trim_to_supervisions(keep_overlapping=False).fill_supervisions(shrink_ok=True),
    lambda c: c.transform_text(str.upper), lambda c: c.map_supervisions(_shift_speaker),
    lambda c: c.sort_by_recording_id(ascending=False), lambda c: c.drop_in_memory_data(),
    lambda c: c.with_recording_path_prefix("/data").with_features_path_prefix("/feats"),
])
def test_cut_operations(corpus, kind, op):
    """Equal cuts, or, where the JAX package refuses an operation on a
    MixedCut, the same error."""
    def build(ns):
        cuts = _source(ns, corpus, "mixed" if kind == "mixed" else "featured")
        try:
            return _dicts(op(cuts).to_eager())
        except (AssertionError, AttributeError, TypeError) as e:
            return type(e).__name__

    ours, theirs = _both(build)
    assert ours == theirs
    assert kind == "mixed" or len(ours) > 0


def _shift_speaker(sup):
    return dataclasses.replace(sup, speaker=f"{sup.speaker}-x")


def test_windows_keep_every_supervision(corpus):
    """Back-to-back windows keep every supervision, and the supervised time
    inside the windows adds up to the source's."""
    cuts = _cuts(PORT, corpus)
    windows = cuts.cut_into_windows(duration=1.0).to_eager()
    assert len(windows) == 4 + 3 + 3
    assert {s.id for c in windows for s in c.supervisions} == {
        s.id for c in cuts for s in c.supervisions}
    inside = sum(s.duration for c in windows for s in c.trimmed_supervisions)
    assert inside == pytest.approx(sum(s.duration for c in cuts for s in c.supervisions), abs=1e-9)
    assert [c.id for c in windows][:4] == [f"{next(iter(cuts)).id}-{i}" for i in range(4)]


def test_index_supervisions_and_masks(corpus):
    def build(ns):
        cuts = _source(ns, corpus, "featured")
        mixed = _source(ns, corpus, "mixed")
        index = {k: sorted((s.id, s.start, s.end) for s in v)
                 for k, v in cuts.index_supervisions().items()}
        mixed_index = {k: len(v) for k, v in mixed.index_supervisions(
            index_mixed_tracks=True, keep_ids={"s0", "s3"}).items()}
        masks = []
        for cut in list(cuts) + list(mixed):
            for ali in (None, "word"):
                masks.append(cut.supervisions_feature_mask(use_alignment_if_exists=ali))
                masks.append(cut.supervisions_audio_mask(use_alignment_if_exists=ali))
        return index, mixed_index, masks

    (index, mixed_index, masks), (jindex, jmixed_index, jmasks) = _both(build)
    assert index == jindex and mixed_index == jmixed_index
    assert len(masks) == len(jmasks) == 20
    for ours, theirs in zip(masks, jmasks):
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    assert masks[0].sum() > 0


def test_trimmed_supervisions(corpus):
    def build(ns):
        return [[s.to_dict() for s in cut.trimmed_supervisions]
                for cut in _cuts(ns, corpus).cut_into_windows(1.5)]

    ours, theirs = _both(build)
    assert ours == theirs and any(ours)


@pytest.mark.parametrize("tabulate", [True, False])
@pytest.mark.parametrize("full", [False, True])
def test_describe(corpus, monkeypatch, tabulate, full):
    for ns in (PORT, JAX):
        monkeypatch.setattr(ns.describe, "is_module_available", lambda *m: tabulate)

    def printed(ns):
        buf = io.StringIO()
        with redirect_stdout(buf):
            _cuts(ns, corpus).trim_to_supervisions().describe(full=full)
        return buf.getvalue()

    ours, theirs = _both(printed)
    assert ours == theirs and "Cuts count:" in ours
    stats = _both(lambda ns: ns.describe.CutSetStatistics(full=full).accumulate(_cuts(ns, corpus)))
    combined = [s.combine(s) for s in stats]
    assert combined[0].render() == combined[1].render()


def test_find_segments_with_speaker_count(corpus):
    cuts = list(_cuts(PORT, corpus))
    jcuts = list(_cuts(JAX, corpus))
    for lo, hi in [(0, 0), (1, None), (2, 2), (1, 1), (0, 1)]:
        for cut, jcut in zip(cuts, jcuts):
            ours = pdescribe.find_segments_with_speaker_count(cut, lo, hi)
            theirs = jdescribe.find_segments_with_speaker_count(jcut, lo, hi)
            assert [(s.start, s.end) for s in ours] == [(s.start, s.end) for s in theirs]


def test_global_feature_stats_and_decompose(corpus, tmp_path):
    ours = _cuts(PORT, corpus, features=True).compute_global_feature_stats(
        storage_path=tmp_path / "stats.pkl")
    theirs = _cuts(JAX, corpus, features=True).compute_global_feature_stats()
    assert set(ours) == set(theirs) == {"norm_means", "norm_stds"}
    for key in ours:
        np.testing.assert_allclose(ours[key], theirs[key], atol=STATS_TOL, rtol=0)
    assert (tmp_path / "stats.pkl").is_file()
    with pytest.raises(ValueError, match="features"):
        _cuts(PORT, corpus).compute_global_feature_stats()

    def decomposed(ns):
        cuts = _source(ns, corpus, "featured").trim_to_supervisions()
        return [None if m is None else _dicts(m) for m in cuts.decompose()]

    ours, theirs = _both(decomposed)
    assert ours == theirs and len(ours[1]) == 6
    PORT.seed(0)
    _cuts(PORT, corpus, features=True).decompose(output_dir=tmp_path / "ours")
    JAX.seed(0)
    _cuts(JAX, corpus, features=True).decompose(output_dir=tmp_path / "jax")
    for name in ("recordings", "supervisions", "features"):
        read = lambda d: gzip.decompress((tmp_path / d / f"{name}.jsonl.gz").read_bytes())  # noqa: E731
        assert read("ours") == read("jax"), name


def test_mixed_cut_in_memory_and_prefixes(corpus):
    """MixedCut's move_to_memory/drop_in_memory_data and path prefixes
    rebuild every track as the JAX package's do."""
    def build(ns):
        mixed = next(iter(_source(ns, corpus, "mixed")))
        moved = mixed.move_to_memory()
        return (moved.is_in_memory, mixed.is_in_memory, moved.load_audio(),
                moved.drop_in_memory_data().to_dict(),
                mixed.with_recording_path_prefix("/r").to_dict())

    ours, theirs = _both(build)
    assert ours[0] is theirs[0] is True and ours[1] is theirs[1] is False
    np.testing.assert_array_equal(ours[2], theirs[2])
    assert ours[3:] == theirs[3:]
    assert isinstance(next(iter(_source(PORT, corpus, "mixed"))), MixedCut)
