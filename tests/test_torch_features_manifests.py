"""
The port's feature manifests (lhotse_tpu_torch.features.base, cut/, qa.py,
serialization.py) against the JAX package's: ``Features``, ``FeatureSet``
and cut dicts are equal both ways, through ``to_file``/``from_file``;
``load_features`` gives the same windows (mid-chunk starts, the off-by-one
frame forgiveness); ``validate_features`` and ``validate`` accept and refuse
the same manifests; an extractor dict the JAX package wrote resolves in the
port and keeps its ``device: cpu``; the global statistics are equal.
"""
import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.features.base import FeatureExtractor as JFeatureExtractor
from lhotse_tpu.features.base import Features as JFeatures
from lhotse_tpu.qa import validate_features as jvalidate_features
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.features import (
    Fbank, FbankConfig, FeatureExtractor, Features, FeatureSet, LilcomChunkyWriter,
    compute_global_stats, get_extractor_type)
from lhotse_tpu_torch.qa import validate, validate_features
from lhotse_tpu_torch.supervision import SupervisionSegment

SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three FLAC recordings of 12, 7.3 and 1.04 s, their features (the
    port's Fbank on the CPU) in one chunky archive, and full-length cuts."""
    root = tmp_path_factory.mktemp("feats_corpus")
    rng = np.random.default_rng(11)
    extractor = Fbank(FbankConfig(device="cpu"))
    cuts = []
    with LilcomChunkyWriter(root / "feats") as writer:
        for i, sec in enumerate([12.0, 7.3, 1.04]):
            path = root / f"r{i}.flac"
            write_flac(str(path), (0.1 * rng.standard_normal(int(SR * sec))).astype(np.float32), SR)
            rec = Recording.from_file(path)
            feats = extractor.extract_from_recording_and_store(rec, writer, channels=0)
            cut = rec.to_cut()
            cut.features = feats
            cut.supervisions.append(SupervisionSegment(
                id=f"s{i}", recording_id=rec.id, start=0.5, duration=sec - 0.6, text="t"))
            cuts.append(cut)
    CutSet.from_cuts(cuts).to_file(root / "cuts.jsonl")
    return root, cuts


def test_features_and_feature_set_dicts_equal_jax(corpus, tmp_path):
    root, cuts = corpus
    feats = [c.features for c in cuts]
    for f in feats:
        assert JFeatures.from_dict(f.to_dict()).to_dict() == f.to_dict()
        assert Features.from_dict(JFeatures.from_dict(f.to_dict()).to_dict()) == f
    FeatureSet(feats).to_file(tmp_path / "feats.jsonl.gz")
    jset = J.FeatureSet.from_file(tmp_path / "feats.jsonl.gz")
    assert [f.to_dict() for f in jset] == [f.to_dict() for f in feats]
    jset.to_file(tmp_path / "jfeats.jsonl")
    ours = FeatureSet.from_file(tmp_path / "jfeats.jsonl")
    assert isinstance(ours, FeatureSet) and list(ours) == feats
    validate(FeatureSet(feats), read_data=True)


def test_cut_dicts_equal_jax_both_ways(corpus):
    root, cuts = corpus
    jcuts = list(J.CutSet.from_file(root / "cuts.jsonl"))
    assert [c.to_dict() for c in jcuts] == [c.to_dict() for c in cuts]
    J.CutSet.from_cuts(jcuts).to_file(root / "jcuts.jsonl")
    back = list(CutSet.from_file(root / "jcuts.jsonl"))
    assert back == cuts
    assert [c.to_dict() for c in back] == [c.to_dict() for c in cuts]


WINDOWS = [(0.0, None), (4.87, 2.5), (5.0, 1.0), (0.013, 0.4), (11.2, 0.8)]


@pytest.mark.parametrize("start,duration", WINDOWS)
def test_load_features_windows_equal_jax(corpus, start, duration):
    root, cuts = corpus
    cut = cuts[0]
    duration = cut.duration - start if duration is None else duration
    ours = MonoCut(id="w", start=start, duration=duration, channel=0, features=cut.features,
                   recording=cut.recording)
    jcut = J.MonoCut.from_dict(ours.to_dict())
    got = ours.load_features()
    assert got.shape == (ours.num_frames, 80) and ours.num_frames == jcut.num_frames
    assert np.array_equal(got, jcut.load_features())
    full = cut.load_features()
    left = round(start * 100)
    assert np.array_equal(got[:-1], full[left : left + got.shape[0] - 1])


def test_supervisions_feature_mask_equals_jax(corpus):
    root, cuts = corpus
    for cut in cuts:
        jcut = J.MonoCut.from_dict(cut.to_dict())
        assert np.array_equal(cut.supervisions_feature_mask(), jcut.supervisions_feature_mask())


def _bad(features: Features, **fields) -> dict:
    return dict(features.to_dict(), **fields)


def test_validate_features_behaves_as_jax(corpus):
    root, cuts = corpus
    f = cuts[1].features
    data = cuts[1].load_features()
    validate_features(f, read_data=True)
    jvalidate_features(JFeatures.from_dict(f.to_dict()), read_data=True)
    validate_features(f, feats_data=data)
    cases = [
        _bad(f, num_frames=f.num_frames + 1),  # inconsistent with the duration
        _bad(f, frame_shift=0.0100001),  # a fractional window hop
        _bad(f, duration=0.0),
        _bad(f, num_features=0),
        _bad(f, start=-1.0),
    ]
    for d in cases:
        with pytest.raises(AssertionError):
            validate_features(Features.from_dict(dict(d)))
        with pytest.raises(AssertionError):
            jvalidate_features(JFeatures.from_dict(dict(d)))
    for arr in (data[:-2], data[:, :40]):
        with pytest.raises(AssertionError):
            validate_features(f, feats_data=arr)
        with pytest.raises(AssertionError):
            jvalidate_features(JFeatures.from_dict(f.to_dict()), feats_data=arr)


def test_validate_cut_with_features(corpus):
    root, cuts = corpus
    for cut in cuts:
        validate(cut, read_data=True)
    wrong_channel = cuts[0].copy(features=cuts[0].features.copy_with(channels=1))
    with pytest.raises(AssertionError):
        validate(wrong_channel)
    with pytest.raises(AssertionError):
        J.qa.validate(J.MonoCut.from_dict(wrong_channel.to_dict()))


def test_extractor_dict_from_jax_resolves_and_keeps_cpu(corpus):
    root, cuts = corpus
    jdict = J.Fbank().to_dict()
    assert jdict["device"] == "cpu"
    ours = FeatureExtractor.from_dict(jdict)
    assert isinstance(ours, Fbank) and str(ours.device) == "cpu"
    # The caller's explicit device is honoured: it extracts on the CPU.
    audio = cuts[2].load_audio()
    assert ours.extract(audio, SR).shape == (cuts[2].features.num_frames, 80)
    assert get_extractor_type(cuts[0].features.type) is Fbank
    back = JFeatureExtractor.from_dict(FeatureExtractor.from_dict(jdict).to_dict())
    assert back.to_dict() == jdict
    for name in ("kaldi-mfcc", "kaldi-spectrogram", "kaldi-log-spectrogram"):
        jext = J.features.base.get_extractor_type(name)()
        assert type(FeatureExtractor.from_dict(jext.to_dict())).name == name


def test_global_stats_equal_jax(corpus):
    root, cuts = corpus
    ours = compute_global_stats([c.features for c in cuts])
    theirs = J.features.base.compute_global_stats(
        [JFeatures.from_dict(c.features.to_dict()) for c in cuts])
    for k in ("norm_means", "norm_stds"):
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_drop_features(corpus):
    root, cuts = corpus
    dropped = CutSet.from_cuts(cuts).drop_features()
    assert not any(c.has_features for c in dropped)
    assert [c.to_dict() for c in dropped] == [
        c.to_dict() for c in J.CutSet.from_cuts(
            [J.MonoCut.from_dict(c.to_dict()) for c in cuts]).drop_features()]
