"""
The port's meeting-task datasets (lhotse_tpu_torch.dataset: ``VadDataset``,
``DiarizationDataset`` with and without a UEM, ``K2SurtDataset`` with
``strict`` and ``return_sources``, ``adjust_source_feats`` and its
``validate_for_asr``) and the per-speaker activity masks they build on
(``Cut.speakers_feature_mask``, ``speakers_audio_mask``,
``CutSet.speakers``), against the JAX package's on a small AMI corpus (the
layout of tests/test_torch_ami.py: four 20 s meetings, two speakers with
overlapping turns) prepared with ``prepare_ami(mic="sdm")`` by the JAX
package.

Masks, activity matrices, supervisions and text are compared exactly.
Stored features are read by both packages from one JAX-written
``lilcom_chunky`` archive and compared exactly; the port's own archive of
the same windows is within one LTC1 tick of JAX's. Features extracted on
the fly are held to the JAX fbank layer's kernel route (XLA) at 1e-4
(the feature budget): the corpus is tonal, where the JAX extractor's
explicit-preprocessing device route parts from it.
"""
import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.dataset.diarization import DiarizationDataset as JDiarization
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.input_strategies import PrecomputedFeatures as JPrecomputed
from lhotse_tpu.dataset.sampling import SimpleCutSampler as JSimple
from lhotse_tpu.dataset.surt import K2SurtDataset as JSurt
from lhotse_tpu.dataset.surt import adjust_source_feats as jadjust
from lhotse_tpu.dataset.surt import validate_for_asr as jvalidate_for_asr
from lhotse_tpu.dataset.vad import VadDataset as JVad
from lhotse_tpu.features.kaldi import layers as jl
from lhotse_tpu.recipes import ami as jami
from lhotse_tpu.utils import fastcopy as jfastcopy
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import (
    DiarizationDataset, K2SurtDataset, SimpleCutSampler, VadDataset)
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.surt import adjust_source_feats, validate_for_asr
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.features.io import LilcomChunkyWriter
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import fastcopy, fix_random_seed
from test_torch_ami import _ami_corpus
from test_torch_layers import _jax_fused_route

SR = 16000
FEATURE_TOL = 1e-4  # on the fly vs the JAX layer's kernel route in XLA
LTC1_TICK = 2.0 ** -5  # the chunky archive's quantum at tick_power=-5
MEETINGS = ["ES2002a", "ES2002b", "ES2011a", "ES2004a"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The ``sdm`` train sessions (one MonoCut per 20 s meeting, both
    speakers' turns), their 5 s windows with features in a JAX-written
    ``lilcom_chunky`` archive, and the supervision groups of the sessions
    with one overlapping turn added, each as a JAX-written JSONL
    manifest."""
    root = tmp_path_factory.mktemp("task_datasets")
    ami = _ami_corpus(root / "corpus", MEETINGS, seconds=20.0)
    sdm = jami.prepare_ami(ami, output_dir=root / "manifests", mic="sdm")["train"]
    jfix(0)
    sessions = J.CutSet.from_manifests(**sdm).to_eager()
    sessions.to_file(root / "sessions.jsonl")
    windows = sessions.cut_into_windows(5.0).to_eager()
    windows.to_file(root / "windows.jsonl")
    windows.compute_and_store_features(
        J.Fbank(), root / "jax_feats", storage_type=J.LilcomChunkyWriter,
        progress_bar=False).to_file(root / "windows_feats.jsonl")
    # The recipe's supervisions do not overlap (turns are cut at words): add
    # one of the second speaker over the first's 8.2-11.8 s turn.
    talked_over = J.CutSet.from_cuts(
        jfastcopy(c, supervisions=c.supervisions + [J.SupervisionSegment(
            id=f"{c.recording_id}-over", recording_id=c.recording_id, start=10.0, duration=3.5,
            channel=c.supervisions[-1].channel, text="OVER TALK",
            speaker=c.supervisions[-1].speaker)]) for c in sessions)
    talked_over.trim_to_supervision_groups(max_pause=0.5).to_eager().to_file(root / "groups.jsonl")
    return root


def _load(corpus, pkg, name):
    return (CutSet if pkg == "port" else J.CutSet).from_file(corpus / f"{name}.jsonl")


def _both(build):
    fix_random_seed(0)
    ours = build("port")
    jfix(0)
    theirs = build("jax")
    return ours, theirs


# -- the masks -------------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    {}, {"min_speaker_dim": 4}, {"min_speaker_dim": 1},
    {"speaker_to_idx_map": {"MEE00": 1, "FEE10": 0, "MEE01": 2, "FEE11": 3}},
    {"use_alignment_if_exists": "word"}])
@pytest.mark.parametrize("mask", ["speakers_feature_mask", "speakers_audio_mask"])
def test_speaker_masks_equal_jax(corpus, mask, kwargs):
    name = "windows_feats" if mask == "speakers_feature_mask" else "sessions"
    ours, theirs = _load(corpus, "port", name), _load(corpus, "jax", name)
    for a, b in zip(ours, theirs):
        if "speaker_to_idx_map" in kwargs and not {s.speaker for s in a.supervisions} <= set(
                kwargs["speaker_to_idx_map"]):
            continue
        got, want = getattr(a, mask)(**kwargs), getattr(b, mask)(**kwargs)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        units = a.num_frames if mask == "speakers_feature_mask" else a.num_samples
        assert got.shape[1] == units and got.shape[0] >= kwargs.get("min_speaker_dim", 0)


def test_speaker_masks_need_their_data(corpus):
    cut = _load(corpus, "port", "sessions")[0]
    with pytest.raises(AssertionError, match="No features"):
        cut.speakers_feature_mask()
    with pytest.raises(AssertionError, match="No recording"):
        _load(corpus, "port", "windows_feats")[0].drop_recording().speakers_audio_mask()


@pytest.mark.parametrize("name", ["sessions", "windows", "groups"])
def test_cutset_speakers_equal_jax(corpus, name):
    ours, theirs = _load(corpus, "port", name).speakers, _load(corpus, "jax", name).speakers
    assert isinstance(ours, frozenset) and ours == theirs and len(ours) >= 2


# -- VAD -------------------------------------------------------------------------------------


def test_vad_on_stored_features_equals_jax(corpus):
    ours = VadDataset()[next(iter(SimpleCutSampler(_load(corpus, "port", "windows_feats"),
                                                   max_cuts=4)))]
    theirs = JVad()[next(iter(JSimple(_load(corpus, "jax", "windows_feats"), max_cuts=4)))]
    assert [c.id for c in ours["cut"]] == [c.id for c in theirs["cut"]]
    for key in ("inputs", "input_lens", "is_voice"):
        assert np.array_equal(ours[key], theirs[key]), key
    assert ours["is_voice"].shape == ours["inputs"].shape[:2]
    assert 0 < ours["is_voice"].mean() < 1


def test_vad_on_the_fly_holds_to_jax(corpus):
    """``OnTheFlyFeatures`` on the port's CPU route against the JAX layer's
    kernel route over the JAX dataset's audio of the same cuts."""
    ours_ds = VadDataset(input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    layer = jl.Wav2LogFilterBank()
    for a_cuts, b_cuts in zip(SimpleCutSampler(_load(corpus, "port", "windows"), max_duration=20),
                              JSimple(_load(corpus, "jax", "windows"), max_duration=20)):
        ours = ours_ds[a_cuts]
        theirs = JVad(input_strategy=JAudioSamples())[b_cuts]
        assert [c.id for c in ours["cut"]] == [c.id for c in theirs["cut"]]
        for i, cut in enumerate(theirs["cut"]):
            want = np.asarray(_jax_fused_route(layer, theirs["inputs"][i:i + 1, :cut.num_samples]))[0]
            assert ours["input_lens"][i] == want.shape[0]
            np.testing.assert_allclose(ours["inputs"][i, :want.shape[0]], want, rtol=0,
                                       atol=FEATURE_TOL)
        # The masks of the frame grid: the JAX package's on its own features.
        jfeat = JVad(input_strategy=JPrecomputed())[
            J.CutSet.from_cuts(c for c in _load(corpus, "jax", "windows_feats")
                               if c.id in {x.id for x in b_cuts})]
        assert np.array_equal(ours["is_voice"], jfeat["is_voice"])


# -- diarization -----------------------------------------------------------------------------


def _uem(pkg, corpus):
    sup, sset = ((J.SupervisionSegment, J.SupervisionSet) if pkg == "jax"
                 else (SupervisionSegment, SupervisionSet))
    return sset.from_segments(
        sup(id=f"uem-{c.recording_id}", recording_id=c.recording_id, start=2.0, duration=10.0)
        for c in _load(corpus, pkg, "sessions"))


@pytest.mark.parametrize("kwargs", [
    {}, {"global_speaker_ids": True}, {"global_speaker_ids": True, "min_speaker_dim": 4},
    {"uem": True}, {"uem": True, "global_speaker_ids": True, "min_speaker_dim": 3}])
def test_diarization_equals_jax(corpus, kwargs):
    """``speaker_activity`` (B, S, T) with -100 on padded speaker rows, the
    features of the stored archive, the speaker map and, with a UEM, the
    dataset's cuts."""
    def build(pkg):
        kw = dict(kwargs)
        if kw.pop("uem", False):
            kw["uem"] = _uem(pkg, corpus)
        cuts = _load(corpus, pkg, "windows_feats")
        return (DiarizationDataset if pkg == "port" else JDiarization)(cuts, **kw), cuts

    (ours_ds, ours_cuts), (theirs_ds, theirs_cuts) = _both(build)
    assert ours_ds.speakers == theirs_ds.speakers
    assert [c.to_dict() for c in ours_ds.cuts] == [c.to_dict() for c in theirs_ds.cuts]
    # Four 5 s windows (the activity matrices are stacked, so a batch has
    # one length), of one or two speakers each.
    batch_ids = [c.id for c in ours_cuts][:4]
    ours = ours_ds[ours_cuts.subset(cut_ids=batch_ids)]
    theirs = theirs_ds[theirs_cuts.subset(cut_ids=batch_ids)]
    for key in ("features", "features_lens", "speaker_activity"):
        assert ours[key].dtype == theirs[key].dtype and np.array_equal(ours[key], theirs[key]), key
    act = ours["speaker_activity"]
    assert act.shape[0] == 4 and act.shape[2] == ours["features"].shape[1]
    assert act.shape[1] >= kwargs.get("min_speaker_dim", 2)
    assert set(np.unique(act)) <= {-100.0, 0.0, 1.0} and (act == 1).any()
    if not kwargs.get("global_speaker_ids") and "min_speaker_dim" not in kwargs:
        # A window with fewer speakers than the batch's most gets -100 rows.
        counts = [len({s.speaker for s in c.supervisions})
                  for c in ours_cuts.subset(cut_ids=batch_ids)]
        assert len(set(counts)) > 1
        for i, n in enumerate(counts):
            assert (act[i, n:] == -100).all() and not (act[i, :n] == -100).any()


def test_uem_intersection_trims_supervisions(corpus):
    """Over whole sessions (cut ids that the UEM's cuts share) each
    supervision is cut to the scored region [2, 12) s. The JAX package
    raises here (ROADMAP C1): it collects the trimmed segments in a set, and
    a SupervisionSegment is not hashable. Cuts the UEM does not name (the
    windows above) keep their supervisions in both packages."""
    with pytest.raises(TypeError, match="unhashable"):
        JDiarization(_load(corpus, "jax", "sessions"), uem=_uem("jax", corpus))
    sessions = _load(corpus, "port", "sessions")
    ds = DiarizationDataset(sessions, uem=_uem("port", corpus))
    sups = [s for c in ds.cuts for s in c.supervisions]
    want = [s.trim(12.0, start=2.0) for c in sessions for s in c.supervisions
            if s.end > 2.0 and s.start < 12.0]
    assert sorted((s.id, s.start, s.duration) for s in sups) == sorted(
        (s.id, s.start, s.duration) for s in want)
    assert sups and all(s.start >= 2.0 - 1e-6 and s.end <= 12.0 + 1e-6 for s in sups)


def test_port_archive_within_one_tick_of_jax(corpus, tmp_path):
    """The port's own ``lilcom_chunky`` archive of the windows (its CPU
    route) against the JAX-written one: within one LTC1 tick; the
    diarization activity on either is the same."""
    ours = _load(corpus, "port", "windows").compute_and_store_features(
        Fbank(FbankConfig(device="cpu")), tmp_path / "feats", storage_type=LilcomChunkyWriter,
        progress_bar=False).to_eager()
    theirs = _load(corpus, "jax", "windows_feats")
    for a, b in zip(ours, theirs):
        assert np.abs(a.load_features() - b.load_features()).max() <= LTC1_TICK
    ids = [c.id for c in ours][:3]
    act = DiarizationDataset(ours)[ours.subset(cut_ids=ids)]["speaker_activity"]
    jact = JDiarization(theirs)[theirs.subset(cut_ids=ids)]["speaker_activity"]
    assert np.array_equal(act, jact)


# -- SURT ------------------------------------------------------------------------------------


def _surt_batch(pkg, cuts, **kwargs):
    if pkg == "port":
        strategy = OnTheFlyFeatures(Fbank(FbankConfig(device="cpu")))
        return K2SurtDataset(input_strategy=strategy, return_cuts=True, **kwargs)[cuts]
    return JSurt(input_strategy=JAudioSamples(), return_cuts=True, **kwargs)[cuts]


@pytest.mark.parametrize("kwargs", [
    {}, {"num_channels": 3}, {"num_channels": 1}, {"num_channels": 1, "strict": True},
    {"text_delimiter": "|"}, {"return_alignments": True}])
def test_surt_equals_jax(corpus, kwargs, capsys):
    """HEAT assignment of each group's supervisions to N channels, the
    per-channel text, the dropped cuts of ``strict``, and the features on
    the fly against the JAX layer's kernel route."""
    ours = _surt_batch("port", _load(corpus, "port", "groups"), **kwargs)
    ours_out = capsys.readouterr().out
    theirs = _surt_batch("jax", _load(corpus, "jax", "groups"), **kwargs)
    assert capsys.readouterr().out == ours_out
    assert ours["text"] == theirs["text"]
    assert [[[s.to_dict() for s in ch] for ch in cut] for cut in ours["supervisions"]] == [
        [[s.to_dict() for s in ch] for ch in cut] for cut in theirs["supervisions"]]
    assert [c.to_dict() for c in ours["cuts"]] == [c.to_dict() for c in theirs["cuts"]]
    n = kwargs.get("num_channels", 2)
    assert all(len(t) == n for t in ours["text"])
    if kwargs.get("strict"):
        assert "removed" in ours_out and len(ours["cuts"]) < len(_load(corpus, "port", "groups"))
    layer = jl.Wav2LogFilterBank()
    for i, cut in enumerate(theirs["cuts"]):
        want = np.asarray(_jax_fused_route(layer, theirs["inputs"][i:i + 1, :cut.num_samples]))[0]
        assert ours["input_lens"][i] == want.shape[0]
        np.testing.assert_allclose(ours["inputs"][i, :want.shape[0]], want, rtol=0, atol=FEATURE_TOL)


def test_surt_overlap_goes_to_a_second_channel(corpus):
    """The added turn (10-13.5 s) overlaps the first speaker's (8.2-11.8 s):
    with two channels it goes to channel 1."""
    batch = K2SurtDataset(input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))[
        _load(corpus, "port", "groups")]
    assert any(len(ch[1]) > 0 for ch in batch["supervisions"])


@pytest.fixture(scope="module")
def sourced(corpus, tmp_path_factory):
    """The supervision groups with features (the frame grid of the source
    boundaries), ``source_feats`` (an Array of each supervision's frames,
    stacked) and ``source_feat_offsets``, written by the JAX
    package; each group's first supervision has one row too few, within
    ``adjust_source_feats``'s tolerance."""
    root = tmp_path_factory.mktemp("surt_sources")
    rng = np.random.default_rng(9)
    cuts = []
    groups = _load(corpus, "jax", "groups").compute_and_store_features(
        J.Fbank(), root / "feats", storage_type=J.LilcomChunkyWriter, progress_bar=False)
    with J.NumpyFilesWriter(root / "sources") as writer:
        for cut in groups:
            # The dataset splits the rows in the cut's supervision order and
            # pairs them with the boundaries in (start, speaker) order.
            sups = sorted(cut.supervisions, key=lambda s: (s.start, s.speaker))
            cut = jfastcopy(cut, supervisions=sups)
            rows = [J.utils.compute_num_frames(s.end, 0.01, SR)
                    - J.utils.compute_num_frames(s.start, 0.01, SR) - (k == 0) for k, s in enumerate(sups)]
            feats = rng.standard_normal((sum(rows), 80)).astype(np.float32)
            # A plain Array: a TemporalArray would be read back as the cut's
            # window, shorter than the stacked (overlapping) sources.
            arr = writer.store_array(cut.id, feats)
            cuts.append(cut.with_custom("source_feats", arr).with_custom(
                "source_feat_offsets", [int(o) for o in np.cumsum([0] + rows[:-1])]))
    J.CutSet.from_cuts(cuts).to_file(root / "sourced.jsonl")
    return root / "sourced.jsonl"


def test_surt_return_sources_equals_jax(sourced):
    ours = _surt_batch("port", CutSet.from_file(sourced), return_sources=True)
    theirs = _surt_batch("jax", J.CutSet.from_file(sourced), return_sources=True)
    assert ours["source_boundaries"] == theirs["source_boundaries"]
    assert len(ours["source_feats"]) == len(theirs["source_feats"]) > 0
    for a, b in zip(ours["source_feats"], theirs["source_feats"]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for feats, bounds in zip(ours["source_feats"], ours["source_boundaries"]):
        assert [f.shape[0] for f in feats] == [end - start for start, end in bounds]


@pytest.mark.parametrize("rows,frames", [(10, 10), (9, 10), (12, 10), (10, 8), (5, 10)])
def test_adjust_source_feats_equals_jax(rows, frames):
    x = np.random.default_rng(rows).standard_normal((rows, 4)).astype(np.float32)
    try:
        want = jadjust(x, frames, padding_value=-7.0)
    except ValueError:
        with pytest.raises(ValueError, match="not close"):
            adjust_source_feats(x, frames, padding_value=-7.0)
        return
    got = adjust_source_feats(x, frames, padding_value=-7.0)
    assert got.shape == (frames, 4) and np.array_equal(got, want)


def test_surt_validate_for_asr_compares_duration_as_jax(corpus):
    """The SURT module's ``validate_for_asr`` holds each supervision's
    duration, not its end, to the cut's duration (the JAX package's
    behaviour): a supervision that ends past a cut but is shorter than it
    passes, one longer than the cut fails."""
    cases = []
    for pkg, copy_, validate in (("port", fastcopy, validate_for_asr),
                                 ("jax", jfastcopy, jvalidate_for_asr)):
        cut = _load(corpus, pkg, "groups")[0]
        sup = cut.supervisions[0]
        late = copy_(cut, supervisions=[copy_(sup, start=cut.duration - sup.duration / 2)])
        long = copy_(cut, supervisions=[copy_(sup, start=0.0, duration=cut.duration + 0.5)])
        validate(CutSet.from_cuts([late]) if pkg == "port" else J.CutSet.from_cuts([late]))
        with pytest.raises(AssertionError, match="ending after"):
            validate(CutSet.from_cuts([long]) if pkg == "port" else J.CutSet.from_cuts([long]))
        cases.append(late.supervisions[0].end > late.duration)
    assert cases == [True, True]
