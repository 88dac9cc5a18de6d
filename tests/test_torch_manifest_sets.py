"""
The port's RecordingSet and SupervisionSet (lhotse_tpu_torch.audio.recording_set,
lhotse_tpu_torch.supervision), its JSON, YAML and JSONL manifests
(lhotse_tpu_torch.serialization.load_manifest) and the QA functions of
lhotse_tpu_torch.qa, against the JAX package's on the same files and inputs.

Sets are compared through ``to_dicts()``; gzipped manifests after
decompression, since a gzip header carries its write time.
"""
import gzip
import logging
from types import SimpleNamespace

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu import qa as jqa
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.audio.wavio import write_wav as jwrite_wav
from lhotse_tpu.serialization import load_manifest as jload_manifest
from lhotse_tpu.testing import dummies as jdummies
from lhotse_tpu_torch import qa as pqa
from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.features import FeatureSet
from lhotse_tpu_torch.serialization import load_manifest
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.testing import dummies as pdummies

SR = 16000

PORT = SimpleNamespace(
    Recording=Recording, RecordingSet=RecordingSet, SupervisionSegment=SupervisionSegment,
    SupervisionSet=SupervisionSet, AlignmentItem=AlignmentItem, CutSet=CutSet,
    FeatureSet=FeatureSet, load_manifest=load_manifest, qa=pqa, dummies=pdummies)
JAX = SimpleNamespace(
    Recording=J.Recording, RecordingSet=J.RecordingSet, SupervisionSegment=J.SupervisionSegment,
    SupervisionSet=J.SupervisionSet, AlignmentItem=J.AlignmentItem, CutSet=J.CutSet,
    FeatureSet=J.FeatureSet, load_manifest=jload_manifest, qa=jqa, dummies=jdummies)


def _dicts(manifest) -> list:
    return [item.to_dict() for item in manifest]


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """Four FLAC files of 0.5-1.7 s, two of them one directory down, and a
    WAV file that the pattern leaves out."""
    root = tmp_path_factory.mktemp("manifest_sets")
    rng = np.random.default_rng(5)
    for i, rel in enumerate(["b.flac", "a.flac", "sub/d.flac", "sub/c.flac"]):
        path = root / rel
        path.parent.mkdir(exist_ok=True)
        x = 0.1 * rng.standard_normal(int(SR * (0.5 + 0.4 * i))).astype(np.float32)
        jwrite_flac(str(path), x, SR)
    jwrite_wav(str(root / "skip.wav"), np.zeros(SR // 4, np.float32), SR)
    return root


def _supervisions(ns):
    """Six segments over two 2 s recordings and one orphan: channels 0 and
    1, an overlap, word alignments, and a custom field."""
    words = [ns.AlignmentItem("hello", 0.1, 0.3), ns.AlignmentItem("world", 0.45, 0.4, 0.9)]
    specs = [
        ("s0", "r0", 0.0, 0.9, 0, "hello world", words), ("s1", "r0", 0.8, 0.6, 0, "overlap", None),
        ("s2", "r0", 1.5, 0.5, 1, "channel one", None), ("s3", "r1", 0.25, 1.0, 0, "second", None),
        ("s4", "r1", 1.2, 0.7, [0, 1], "both", None), ("s5", "orphan", 0.0, 1.0, 0, "x", None),
    ]
    return ns.SupervisionSet.from_segments(
        ns.SupervisionSegment(
            id=i, recording_id=r, start=st, duration=d, channel=ch, text=t, speaker=f"spk-{r}",
            custom={"src": i}, alignment=None if a is None else {"word": a})
        for i, r, st, d, ch, t, a in specs)


def test_recording_set_from_dir_and_dicts(audio_dir):
    ours = RecordingSet.from_dir(audio_dir, "*.flac")
    theirs = J.RecordingSet.from_dir(audio_dir, "*.flac")
    assert [r.id for r in ours] == ["a", "b", "c", "d"]
    assert _dicts(ours) == _dicts(theirs)
    # Two spawned workers and a custom id give the same set.
    by_name = RecordingSet.from_dir(audio_dir, "*.flac", num_jobs=2, recording_id=_stem_upper)
    assert [r.id for r in by_name] == ["A", "B", "C", "D"]
    assert _dicts(RecordingSet.from_dir(audio_dir, "*.flac", exclude_pattern="a.*")) == _dicts(
        J.RecordingSet.from_dir(audio_dir, "*.flac", exclude_pattern="a.*"))
    assert _dicts(RecordingSet.from_dicts(ours.to_dicts())) == _dicts(theirs)
    assert ours["c"].to_dict() == theirs["c"].to_dict() and "d" in ours and len(ours) == 4
    np.testing.assert_array_equal(
        ours.load_audio("b", offset_seconds=0.1, duration_seconds=0.2),
        theirs.load_audio("b", offset_seconds=0.1, duration_seconds=0.2))
    prefixed = ours.with_path_prefix("/data")
    assert _dicts(prefixed) == _dicts(theirs.with_path_prefix("/data"))
    assert ours.num_samples("a") == theirs.num_samples("a")


def _stem_upper(path):
    return path.stem.upper()


@pytest.mark.parametrize("builder", [
    lambda s: s.perturb_speed(1.1), lambda s: s.perturb_tempo(0.9), lambda s: s.perturb_volume(2.0),
    lambda s: s.resample(8000), lambda s: s.reverb_rir(room_rng_seed=1, source_rng_seed=2)])
def test_recording_set_builders(audio_dir, builder):
    ours = builder(RecordingSet.from_dir(audio_dir, "*.flac"))
    theirs = builder(J.RecordingSet.from_dir(audio_dir, "*.flac"))
    assert _dicts(ours) == _dicts(theirs)
    np.testing.assert_allclose(ours[0].load_audio(), theirs[0].load_audio(), atol=1e-6)


@pytest.mark.parametrize("kind", ["recordings", "supervisions"])
def test_split_subset_lazy_split(audio_dir, tmp_path, kind):
    def make(ns):
        if kind == "recordings":
            return ns.RecordingSet.from_dir(audio_dir, "*.flac")
        return _supervisions(ns)

    ours, theirs = make(PORT), make(JAX)
    for args in [dict(num_splits=2), dict(num_splits=3, drop_last=True)]:
        assert [_dicts(s) for s in ours.split(**args)] == [_dicts(s) for s in theirs.split(**args)]
    assert _dicts(ours.subset(first=2)) == _dicts(theirs.subset(first=2))
    assert _dicts(ours.subset(last=3)) == _dicts(theirs.subset(last=3))
    assert ours.subset(last=99) is ours
    with pytest.raises(AssertionError):
        ours.subset(first=1, last=1)
    pieces = ours.split_lazy(tmp_path / "ours", chunk_size=3, prefix="p")
    jpieces = theirs.split_lazy(tmp_path / "jax", chunk_size=3, prefix="p")
    assert [type(p).__name__ for p in pieces] == [type(p).__name__ for p in jpieces]
    assert [_dicts(p) for p in pieces] == [_dicts(p) for p in jpieces]


@pytest.mark.parametrize("kwargs", [
    dict(recording_id="r0"), dict(recording_id="r0", channel=0), dict(recording_id="r0", channel=1),
    dict(recording_id="r1", channel=1), dict(recording_id="r0", start_after=0.5),
    dict(recording_id="r0", start_after=0.8005), dict(recording_id="r0", end_before=1.4),
    dict(recording_id="r0", start_after=0.7, end_before=1.4, tolerance=0.2),
    dict(recording_id="r1", start_after=0.25, end_before=2.0, adjust_offset=True),
    dict(recording_id="nothing")])
def test_supervision_find(kwargs):
    ours, theirs = _supervisions(PORT), _supervisions(JAX)
    got = [s.to_dict() for s in ours.find(**kwargs)]
    assert got == [s.to_dict() for s in theirs.find(**kwargs)]
    # The recording-id index is built once and reused.
    assert ours._segments_by_recording_id is not None


def test_supervision_transforms():
    ours, theirs = _supervisions(PORT), _supervisions(JAX)
    assert _dicts(SupervisionSet.from_dicts(ours.to_dicts())) == _dicts(theirs)
    assert _dicts(ours.transform_text(str.upper)) == _dicts(theirs.transform_text(str.upper))
    assert _dicts(ours.transform_alignment(str.upper)) == _dicts(theirs.transform_alignment(str.upper))
    assert ours["s3"].to_dict() == theirs["s3"].to_dict() and "s5" in ours
    trimmed = [s.trim(end=1.0, start=0.2).to_dict() for s in ours]
    assert trimmed == [s.trim(end=1.0, start=0.2).to_dict() for s in theirs]


RTTM = """SPEAKER rec1 1 0.50 2.25 <NA> <NA> alice <NA> <NA>
SPEAKER rec1 1 1.75 0.00 <NA> <NA> bob <NA> <NA>
SPEAKER rec1 0 3.00 1.50 <NA> <NA> bob <NA> <NA>
SPEAKER rec2 0 0.00 4.10 <NA> <NA> carol <NA> <NA>
"""
CTM = """r0 0 0.10 0.30 hello 0.95
r0 0 0.45 0.40 world
r0 1 1.55 0.20 channel 0.50
r1 0 0.30 0.50 second
r1 0 1.30 0.20 both
r1 1 1.50 0.30 again 0.75
"""


def test_rttm_and_ctm(tmp_path):
    rttm = tmp_path / "a.rttm"
    rttm.write_text(RTTM)
    (tmp_path / "b.rttm").write_text(RTTM.replace("rec", "other"))
    for paths in [rttm, [rttm, tmp_path / "b.rttm"]]:
        ours, theirs = SupervisionSet.from_rttm(paths), J.SupervisionSet.from_rttm(paths)
        assert _dicts(ours) == _dicts(theirs) and len(ours) == 3 * (1 if paths is rttm else 2)
    ctm = tmp_path / "words.ctm"
    ctm.write_text(CTM)
    for match_channel in (False, True):
        got = _supervisions(PORT).with_alignment_from_ctm(ctm, match_channel=match_channel)
        want = _supervisions(JAX).with_alignment_from_ctm(ctm, match_channel=match_channel)
        assert _dicts(got) == _dicts(want)
    got.write_alignment_to_ctm(tmp_path / "ours.ctm")
    want.write_alignment_to_ctm(tmp_path / "jax.ctm")
    assert (tmp_path / "ours.ctm").read_bytes() == (tmp_path / "jax.ctm").read_bytes()
    assert (tmp_path / "ours.ctm").read_text().count("\n") >= 4


def _manifests(ns, audio_dir):
    recs = ns.RecordingSet.from_dir(audio_dir, "*.flac")
    feats = ns.dummies.DummyManifest(ns.FeatureSet, begin_id=0, end_id=3)
    cuts = ns.dummies.DummyManifest(ns.CutSet, begin_id=0, end_id=3)
    return {"recordings": recs, "supervisions": _supervisions(ns), "features": feats, "cuts": cuts}


@pytest.mark.parametrize("suffix", [".json", ".yaml", ".jsonl", ".jsonl.gz", ".json.gz"])
def test_round_trips_and_load_manifest(audio_dir, tmp_path, suffix):
    ours, theirs = _manifests(PORT, audio_dir), _manifests(JAX, audio_dir)
    for name, manifest in ours.items():
        mine, jax = tmp_path / f"ours_{name}{suffix}", tmp_path / f"jax_{name}{suffix}"
        manifest.to_file(mine)
        theirs[name].to_file(jax)
        read = gzip.decompress if suffix.endswith(".gz") else (lambda b: b)
        assert read(mine.read_bytes()) == read(jax.read_bytes()), name
        loaded = load_manifest(mine)
        assert type(loaded) is type(manifest), name
        assert _dicts(loaded) == _dicts(jload_manifest(jax)), name
        # from_file opens JSONL lazily and JSON/YAML eagerly; each Set reads
        # the file the JAX package wrote.
        via_file = type(manifest).from_file(jax)
        assert via_file.is_lazy == (".jsonl" in suffix)
        assert _dicts(via_file) == _dicts(manifest), name
    empty = tmp_path / f"empty{suffix}"
    SupervisionSet([]).to_file(empty)
    assert len(load_manifest(empty, manifest_cls=SupervisionSet)) == 0
    if ".jsonl" not in suffix:
        with pytest.raises(ValueError, match="Unknown type"):
            load_manifest(empty)


def test_open_writer_resolves_every_set(audio_dir, tmp_path):
    for name, manifest in _manifests(PORT, audio_dir).items():
        with type(manifest).open_writer(tmp_path / f"{name}.jsonl.gz") as writer:
            for item in manifest:
                writer.write(item)
        reopened = writer.open_manifest()
        assert type(reopened) is type(manifest) and _dicts(reopened) == _dicts(manifest)
        with type(manifest).open_writer(None) as memory:
            for item in manifest:
                memory.write(item)
        assert type(memory.open_manifest()) is type(manifest)


# -- qa: the cases of tests/test_qa.py, on both packages ----------------------------------


def _sup(ns, i, rec="rec", start=0.0, duration=1.0, **kw):
    return ns.SupervisionSegment(
        id=f"sup{i}", recording_id=rec, start=start, duration=duration, channel=0, **kw)


def _qa_case(ns, case):
    """Run one QA case in package ``ns``: the fixed manifests or the error."""
    d = ns.dummies
    try:
        if case == "well_formed":
            recs = d.DummyManifest(ns.RecordingSet, begin_id=0, end_id=3)
            sups = d.DummyManifest(ns.SupervisionSet, begin_id=0, end_id=3)
            ns.qa.validate(recs)
            ns.qa.validate(sups)
            ns.qa.validate_recordings_and_supervisions(recs, sups)
            return "ok"
        if case == "cut_with_data":
            ns.qa.validate(d.dummy_cut(0, with_data=True), read_data=True)
            ns.qa.validate_cut_set(d.DummyManifest(ns.CutSet, begin_id=0, end_id=2, with_data=True))
            return "ok"
        if case == "negative_duration":
            s = _sup(ns, 0)
            s.duration = -1.0
            ns.qa.validate(s)
        if case == "beyond_end":
            rec = d.dummy_recording(0, duration=1.0)
            ns.qa.validate_recordings_and_supervisions(
                ns.RecordingSet([rec]), ns.SupervisionSet([_sup(ns, 0, rec=rec.id, start=0.5, duration=2.0)]))
        if case == "missing_channel":
            rec = d.dummy_recording(0, duration=1.0)
            ns.qa.validate_recordings_and_supervisions(
                ns.RecordingSet([rec]), ns.SupervisionSet([ns.SupervisionSegment(
                    id="s", recording_id=rec.id, start=0.0, duration=0.5, channel=1)]))
        if case == "unknown_recording":
            ns.qa.validate_recordings_and_supervisions(
                ns.RecordingSet([d.dummy_recording(0)]),
                ns.SupervisionSet([_sup(ns, 0, rec="no-such-recording")]))
        if case == "duplicate_ids":
            ns.qa.validate_recording_set(ns.RecordingSet([d.dummy_recording(0)] * 2))
        if case == "remove_missing":
            recs = ns.RecordingSet([d.dummy_recording(0), d.dummy_recording(1)])
            sups = ns.SupervisionSet([_sup(ns, 0, rec=d.dummy_recording(0).id),
                                      _sup(ns, 1, rec="orphaned-rec")])
            recs2, sups2 = ns.qa.remove_missing_recordings_and_supervisions(recs, sups)
            return _dicts(recs2), _dicts(sups2)
        if case == "trim_to_recordings":
            rec = d.dummy_recording(0, duration=2.0)
            sups = [_sup(ns, 0, rec=rec.id, start=0.0, duration=1.0),
                    _sup(ns, 1, rec=rec.id, start=1.5, duration=1.0),
                    _sup(ns, 2, rec=rec.id, start=2.5, duration=1.0)]
            return _dicts(ns.qa.trim_supervisions_to_recordings(rec, sups))
        if case == "fix_manifests":
            rec = d.dummy_recording(0, duration=2.0)
            recs = ns.RecordingSet([rec, d.dummy_recording(1)])
            sups = ns.SupervisionSet([_sup(ns, 0, rec=rec.id, start=0.0, duration=3.0),
                                      _sup(ns, 1, rec="ghost")])
            recs2, sups2 = ns.qa.fix_manifests(recs, sups)
            ns.qa.validate_recordings_and_supervisions(recs2, sups2)
            return _dicts(recs2), _dicts(sups2)
        if case == "nothing_left":
            ns.qa.fix_manifests(ns.RecordingSet([d.dummy_recording(0)]),
                                ns.SupervisionSet([_sup(ns, 0, rec="ghost")]))
        if case == "pair_as_read_data":
            ns.qa.validate(ns.RecordingSet([d.dummy_recording(0)]),
                           ns.SupervisionSet([_sup(ns, 0, rec=d.dummy_recording(0).id)]))
    except (AssertionError, TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    raise AssertionError(f"case {case} returned nothing")


@pytest.mark.parametrize("case", [
    "well_formed", "cut_with_data", "negative_duration", "beyond_end", "missing_channel",
    "unknown_recording", "duplicate_ids", "remove_missing", "trim_to_recordings", "fix_manifests",
    "nothing_left", "pair_as_read_data"])
def test_qa_cases_match_jax(case):
    assert _qa_case(PORT, case) == _qa_case(JAX, case)


def test_qa_warnings_match_jax(caplog):
    def warnings_of(ns):
        recs = ns.RecordingSet([ns.dummies.dummy_recording(0), ns.dummies.dummy_recording(1)])
        rec = next(iter(recs))
        sups = ns.SupervisionSet([_sup(ns, 0, rec=rec.id, duration=rec.duration),
                                  _sup(ns, 1, rec=rec.id, duration=0.5)])
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            ns.qa.validate_recordings_and_supervisions(recs, sups)
            ns.qa.remove_missing_recordings_and_supervisions(recs, sups)
        return list(caplog.messages)

    ours = warnings_of(PORT)
    assert ours == warnings_of(JAX)
    assert any("without any" in m for m in ours) and any("starting at 0" in m for m in ours)

