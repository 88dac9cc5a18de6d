"""
The port's cut audio I/O (``Cut.save_audio``, ``CutSet.save_audios``,
``copy_data`` and ``prefetch`` in ``lhotse_tpu_torch/cut``) and
``DataCut.attach_tensor`` against the JAX package's, on the same cuts: a
mono cut with stored features and a custom array, a two-channel cut, a
mixed cut and a padded cut. The recordings and features are written once,
by the JAX package; the port's cuts are the JAX cuts read back from their
dicts. Manifests are compared as dicts, with each package's output
directory replaced by one placeholder; audio read back is compared with
``np.array_equal`` (the packages write the same bytes), features and arrays
exactly. Three differences are held on purpose (ROADMAP C2), each with
JAX's result beside the port's: a stored cut's supervisions name the
stored recording in the port, where JAX keeps their old ``recording_id``
and ``validate`` refuses the cut; ``save_audio`` of a cut that does not
start at 0 drops the features and temporal arrays that JAX keeps on the
old timeline; and ``copy_data`` stores each cut's own window under its ID,
with its features and custom arrays, where JAX stores audio per recording
(two cuts of one recording overwrite each other) and leaves mixed tracks
and custom arrays pointing at the source.
"""
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.backend import save_audio as jsave_audio
from lhotse_tpu.audio.utils import AudioLoadingError
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.cut import CutSet, MixedCut, MonoCut, MultiCut
from lhotse_tpu_torch.utils import fastcopy, fix_random_seed

SR = 16000
OUT = "<OUT>"


def _tone(rng, seconds: float, channels: int = 1) -> np.ndarray:
    n = int(SR * seconds)
    t = np.arange(n) / SR
    rows = [0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) + 0.01 * rng.standard_normal(n)
            for _ in range(channels)]
    return np.stack(rows).astype(np.float32)


@pytest.fixture(scope="module")
def cuts(tmp_path_factory):
    """The JAX cuts and the port's cuts read from their dicts: a mono FLAC
    cut (1.2 s) with a supervision, fbank features in ``lilcom_chunky`` and
    a per-frame label array in ``numpy_files``, a two-channel WAV cut (1.0 s), a mix of the
    two, and the mono cut padded to 2.0 s (these two without the features
    and the labels)."""
    root = tmp_path_factory.mktemp("cut_audio_io")
    rng = np.random.default_rng(31)
    jsave_audio(root / "mono.flac", _tone(rng, 1.2), SR)
    jsave_audio(root / "stereo.wav", _tone(rng, 1.0, channels=2), SR)
    mono = J.Recording.from_file(root / "mono.flac", recording_id="mono").to_cut()
    mono.supervisions.append(J.SupervisionSegment(
        id="mono-sup", recording_id="mono", start=0.1, duration=0.9, text="a tone",
        speaker="spk1"))
    plain = mono
    with J.LilcomChunkyWriter(root / "feats") as writer:
        mono = mono.compute_and_store_features(JFbank(JFbankConfig()), storage=writer)
    labels = rng.integers(0, 5, size=mono.features.num_frames).astype(np.int32)
    with J.NumpyFilesWriter(root / "arrays") as writer:
        mono.labels = writer.store_array(mono.id, labels, frame_shift=0.01, temporal_dim=0)
    stereo = J.Recording.from_file(root / "stereo.wav", recording_id="stereo").to_cut()
    jfix(0)
    mixed = plain.truncate(duration=0.8).mix(stereo.to_mono()[0], offset_other_by=0.3)
    padded = plain.pad(duration=2.0)
    theirs = J.CutSet.from_cuts([mono, stereo, mixed, padded])
    ours = CutSet.from_dicts([c.to_dict() for c in theirs])
    assert [type(c) for c in ours] == [MonoCut, MultiCut, MixedCut, MixedCut]
    return ours, theirs


def _placeholder(dicts: list, out) -> list:
    return json.loads(json.dumps(dicts, default=repr).replace(str(out), OUT))


def _jax_saved(dicts: list, out) -> list:
    """JAX's stored cuts as the port stores them: with the supervisions
    pointed at the stored recording (ROADMAP C2)."""
    dicts = _placeholder(dicts, out)
    for d in dicts:
        for s in d.get("supervisions", []):
            s["recording_id"] = d["recording"]["id"]
    return dicts


def _audio_equal(ours, theirs) -> None:
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.id == b.id
        assert np.array_equal(a.load_audio(), b.load_audio())


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_save_audio_one_cut_per_kind_equals_jax(cuts, tmp_path, fmt):
    ours, theirs = cuts
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for k, (ocut, jcut) in enumerate(zip(ours, theirs)):
        opath, jpath = tmp_path / "port" / f"c{k}.{fmt}", tmp_path / "jax" / f"c{k}.{fmt}"
        osaved, jsaved = ocut.save_audio(opath), jcut.save_audio(jpath)
        assert opath.read_bytes() == jpath.read_bytes()
        assert _placeholder([osaved.to_dict()], opath) == _jax_saved([jsaved.to_dict()], jpath)
        assert np.array_equal(osaved.load_audio(), jsaved.load_audio())
        assert np.array_equal(osaved.load_audio(), ocut.load_audio())


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_save_audios_layout_and_manifest_equal_jax(cuts, tmp_path, fmt):
    ours, theirs = cuts
    osaved = ours.save_audios(tmp_path / "port", format=fmt, progress_bar=False)
    jsaved = theirs.save_audios(tmp_path / "jax", format=fmt, progress_bar=False)
    assert (_placeholder([c.to_dict() for c in osaved], tmp_path / "port")
            == _jax_saved([c.to_dict() for c in jsaved], tmp_path / "jax"))
    # {id[:3]}/{id}.{format}
    for cut in ours:
        assert (tmp_path / "port" / cut.id[:3] / f"{cut.id}.{fmt}").is_file()
    assert (sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*"))
            == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")))
    _audio_equal(osaved, jsaved)


def test_saved_cuts_validate_where_jax_s_are_refused(cuts, tmp_path):
    """``save_audios`` names each stored recording after its cut; the port's
    supervisions follow, so the stored cuts pass ``validate`` (and so
    ``K2SpeechRecognitionDataset``); JAX's keep their old ``recording_id``
    and are refused."""
    from lhotse_tpu.qa import validate as jvalidate
    from lhotse_tpu_torch.qa import validate

    ours, theirs = cuts
    osaved = ours.save_audios(tmp_path / "port", progress_bar=False)
    jsaved = theirs.save_audios(tmp_path / "jax", progress_bar=False)
    validate(osaved)
    with pytest.raises(AssertionError, match="mismatched recording_id"):
        jvalidate(jsaved)
    for cut in osaved:
        assert cut.recording.id == cut.id
        assert all(s.recording_id == cut.id for s in cut.supervisions)


def test_save_audios_augment_fn_and_executor_equal_jax(cuts, tmp_path):
    """Two jobs on a thread executor (the cuts split after seeding) with an
    ``augment_fn``: the same manifests and samples as JAX's."""
    ours, theirs = cuts

    def augment(x, sr):
        return (x * 0.5).astype(np.float32)

    fix_random_seed(3)
    with ThreadPoolExecutor(2) as pool:
        osaved = ours.save_audios(tmp_path / "port", num_jobs=2, executor=pool,
                                  augment_fn=augment, progress_bar=False)
    jfix(3)
    with ThreadPoolExecutor(2) as pool:
        jsaved = theirs.save_audios(tmp_path / "jax", num_jobs=2, executor=pool,
                                    augment_fn=augment, progress_bar=False)
    assert (_placeholder([c.to_dict() for c in osaved], tmp_path / "port")
            == _jax_saved([c.to_dict() for c in jsaved], tmp_path / "jax"))
    _audio_equal(osaved, jsaved)
    by_id = {c.id: c for c in ours}
    for cut in osaved:  # WAV holds int16: within a quantization step of the augmented audio
        diff = cut.load_audio() - augment(by_id[cut.id].load_audio(), SR)
        assert np.abs(diff).max() <= 1 / 32768


def _located_elsewhere(d: dict) -> dict:
    """A top-level cut's dict without what names where its data lies: the
    recording, the custom arrays and the ``recording_id`` of its features
    and supervisions."""
    d = {k: v for k, v in d.items() if k not in ("recording", "custom")}
    if "features" in d:
        d["features"] = {k: v for k, v in d["features"].items() if k != "recording_id"}
    d["supervisions"] = [{k: v for k, v in s.items() if k != "recording_id"}
                         for s in d.get("supervisions", [])]
    return d


def test_copy_data_layout_manifest_and_contents_equal_jax(cuts, tmp_path):
    """The port's copies read back what the cuts read, and hold what JAX's
    hold but for the two-channel cut (below): the same samples, feature
    bytes and labels; the top-level manifests are JAX's but for where the
    data lies. Where it lies differs on purpose (ROADMAP C2): the port stores
    each data cut under its ID (a mixed cut's tracks under
    ``{id}-track{i}``) and its custom arrays in ``custom/{key}/``, where
    JAX names the audio after the recording and leaves the tracks and the
    arrays pointing at the originals."""
    ours, theirs = cuts
    ocopy = ours.copy_data(tmp_path / "port", verbose=False)
    jcopy = theirs.copy_data(tmp_path / "jax", verbose=False)
    for sub in ("audio", "features.lca", "custom", "cuts.jsonl.gz"):
        assert (tmp_path / "port" / sub).exists() and (tmp_path / "jax" / sub).exists()
    data_ids = [c.id for c in ours if not isinstance(c, MixedCut)]
    data_ids += [f"{c.id}-track{i}" for c in ours if isinstance(c, MixedCut)
                 for i, t in enumerate(c.tracks) if t.type != "PaddingCut"]
    assert (sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port" / "audio").rglob("*.wav"))
            == sorted(Path("audio") / i[:3] / f"{i}.wav" for i in data_ids))
    assert ((tmp_path / "port" / "features.lca").read_bytes()
            == (tmp_path / "jax" / "features.lca").read_bytes())
    _audio_equal(ocopy, ours)
    # JAX stores the mixed cut's second track, channel 0 of "stereo", as
    # audio/stereo.wav too, over the two-channel copy (ROADMAP C2).
    for ocut, jcut in zip(ocopy, jcopy):
        assert np.array_equal(ocut.load_audio(), jcut.load_audio()) is (ocut.id != "stereo")
    assert [c.load_audio().shape[0] for c in jcopy] == [1, 1, 1, 1]
    for ocut, jcut in zip(ocopy, jcopy):
        if not isinstance(ocut, MixedCut):
            assert (_located_elsewhere(_placeholder([ocut.to_dict()], tmp_path / "port")[0])
                    == _located_elsewhere(_placeholder([jcut.to_dict()], tmp_path / "jax")[0]))
    mono = ocopy[0]
    assert mono.recording.sources[0].source == str(
        tmp_path / "port" / "audio" / mono.id[:3] / f"{mono.id}.wav")
    assert mono.recording.id == mono.id
    assert np.array_equal(mono.load_features(), jcopy[0].load_features())
    assert np.array_equal(mono.load_features(), ours[0].load_features())
    assert mono.labels.array.storage_path == str(tmp_path / "port" / "custom" / "labels")
    assert np.array_equal(mono.load_labels(), ours[0].load_labels())
    import h5py

    with h5py.File(tmp_path / "jax" / "custom" / "labels" / "data.h5", "r") as f:
        assert np.array_equal(f[mono.id][()], mono.load_labels())


@pytest.fixture
def one_recording(tmp_path):
    """Two cuts of one 3 s recording (0.2-1.2 s and 1.5-2.5 s, both
    starting past 0), each with the recording's fbank features, a per-frame
    label array over the recording and a plain array, and a mix of the two;
    in both packages, with everything stored under ``src/``."""
    rng = np.random.default_rng(3131)
    src = tmp_path / "src"
    src.mkdir()
    jsave_audio(src / "long.flac", _tone(rng, 3.0), SR)
    whole = J.Recording.from_file(src / "long.flac", recording_id="long").to_cut()
    with J.LilcomChunkyWriter(src / "feats") as writer:
        whole = whole.compute_and_store_features(JFbank(JFbankConfig()), storage=writer)
    with J.NumpyFilesWriter(src / "arrays") as writer:
        whole.labels = writer.store_array(
            "labels", rng.integers(0, 5, size=whole.features.num_frames).astype(np.int32),
            frame_shift=0.01, temporal_dim=0)
        whole.embedding = writer.store_array("embedding", rng.standard_normal(8).astype(np.float32))
    first = fastcopy(whole.truncate(offset=0.2, duration=1.0), id="first")
    second = fastcopy(whole.truncate(offset=1.5, duration=1.0), id="second")
    mixed = fastcopy(first.mix(second, offset_other_by=0.3), id="mixed")
    theirs = [first, second, mixed]
    ours = list(CutSet.from_dicts([c.to_dict() for c in theirs]))
    return ours, theirs, src


def test_copy_data_two_cuts_of_one_recording_read_back_their_own_windows(one_recording, tmp_path):
    """ROADMAP C2. After the source directory is gone, every copy the port
    made reads back what its cut read before: the audio, features, labels
    and array of two cuts of one recording and of their mix. JAX stores
    both cuts' audio as ``audio/long.wav``, so the first reads the second's
    samples; its custom arrays and its mixed cut's tracks still point at
    the source, so they no longer load."""
    ours, theirs, src = one_recording
    before = [(c.load_audio(), c.load_features(),
               None if c.id == "mixed" else (c.load_labels(), c.load_embedding())) for c in ours]
    ocopy = CutSet.from_cuts(ours).copy_data(tmp_path / "port", verbose=False).to_eager()
    jplain = J.CutSet.from_cuts(theirs[:2]).copy_data(tmp_path / "jax", verbose=False).to_eager()
    jmixed = J.CutSet.from_cuts(theirs[2:]).copy_data(tmp_path / "jax_mixed", verbose=False)
    jmixed = jmixed.to_eager()
    src.rename(tmp_path / "gone")

    for cut, (audio, feats, arrays) in zip(ocopy, before):
        assert np.array_equal(cut.load_audio(), audio)
        assert np.array_equal(cut.load_features(), feats)
        if arrays is not None:
            assert np.array_equal(cut.load_labels(), arrays[0])
            assert np.array_equal(cut.load_embedding(), arrays[1])
    for cut in ocopy:
        for track in getattr(cut, "tracks", [cut]):
            data = getattr(track, "cut", track)
            assert data.recording.sources[0].source.startswith(str(tmp_path / "port"))
            assert data.features.storage_path.startswith(str(tmp_path / "port"))
            assert all(str(v.storage_path if hasattr(v, "storage_path") else v.array.storage_path)
                       .startswith(str(tmp_path / "port")) for v in data.custom.values())

    assert sorted(p.name for p in (tmp_path / "jax" / "audio").iterdir()) == ["long.wav"]
    assert np.array_equal(jplain[1].load_audio(), before[1][0])
    assert not np.array_equal(jplain[0].load_audio(), before[0][0])
    with pytest.raises(FileNotFoundError):
        jplain[0].load_labels()
    with pytest.raises(AudioLoadingError):
        jmixed[0].load_audio()


def test_prefetch_yields_the_cuts_in_order_as_jax(cuts):
    ours, theirs = cuts
    before = threading.active_count()
    fetched = list(ours.prefetch(buffer_size=2))
    assert [c.to_dict() for c in fetched] == [c.to_dict() for c in theirs.prefetch(buffer_size=2)]
    assert [c.id for c in fetched] == [c.id for c in ours]
    assert threading.active_count() == before  # the background thread is joined


def test_prefetch_is_bounded_and_raises_the_source_error():
    """The producer stays at most ``buffer_size`` items (plus the one it
    holds) ahead of the consumer, and an error in the source reaches the
    consumer, as in JAX."""
    produced = []

    def source():
        for i in range(10):
            produced.append(i)
            yield i
        raise ValueError("source failed")

    it = iter(CutSet(source()).prefetch(buffer_size=3))
    assert next(it) == 0
    for _ in range(50):
        if len(produced) >= 5:
            break
        threading.Event().wait(0.01)
    assert len(produced) <= 5
    rest = []
    with pytest.raises(ValueError, match="source failed"):
        for item in it:
            rest.append(item)
    assert rest == list(range(1, 10))


# -- attach_tensor ------------------------------------------------------------------------------


@pytest.mark.parametrize("compressed", [False, True])
def test_attach_tensor_temporal_follows_truncate_and_pad_as_jax(cuts, compressed):
    ours, theirs = cuts
    rng = np.random.default_rng(7)
    ocut, jcut = ours[1], theirs[1]  # the two-channel cut, 1.0 s
    scores = rng.standard_normal((100, 3)).astype(np.float32)
    oa = ocut.attach_tensor("scores", scores, frame_shift=0.01, temporal_dim=0,
                            compressed=compressed)
    ja = jcut.attach_tensor("scores", scores, frame_shift=0.01, temporal_dim=0,
                            compressed=compressed)
    assert oa.to_dict() == ja.to_dict()
    assert np.array_equal(oa.load_scores(), ja.load_scores())
    if not compressed:
        assert np.array_equal(oa.load_scores(), scores)
    for op in (lambda c: c.truncate(offset=0.25, duration=0.5),
               lambda c: c.truncate(duration=0.33)):
        fix_random_seed(0)
        o = op(oa)
        jfix(0)
        j = op(ja)
        assert o.to_dict() == j.to_dict()
        assert np.array_equal(o.load_scores(), j.load_scores())
    fix_random_seed(0)
    opad = oa.pad(duration=1.5)
    jfix(0)
    jpad = ja.pad(duration=1.5)
    assert opad.to_dict() == jpad.to_dict()
    assert np.array_equal(opad.load_custom("scores"), jpad.load_custom("scores"))
    assert opad.load_custom("scores").shape[0] == 150


@pytest.mark.parametrize("compressed", [False, True])
def test_attach_tensor_plain_array_equals_jax(cuts, compressed):
    ours, theirs = cuts
    embedding = np.random.default_rng(8).standard_normal(16).astype(np.float32)
    oa = ours[0].attach_tensor("embedding", embedding, compressed=compressed)
    ja = theirs[0].attach_tensor("embedding", embedding, compressed=compressed)
    assert oa.to_dict() == ja.to_dict()
    assert np.array_equal(oa.load_embedding(), ja.load_embedding())
    assert "embedding" not in (ours[0].custom or {})  # the original cut is untouched
    restored = CutSet.from_dicts([oa.to_dict()])[0]
    assert np.array_equal(restored.load_embedding(), oa.load_embedding())


def test_save_audio_of_an_offset_cut_drops_what_would_read_another_window(one_recording, tmp_path):
    """ROADMAP C2. A cut stored by ``save_audio`` starts at 0 of the stored
    recording. The port drops the features and the per-frame labels of a
    cut that started at 1.5 s, which are read from the old recording's
    timeline, and keeps its plain array; JAX keeps them, and its stored
    cut then reads the recording's first second of features and labels."""
    ours, theirs, _ = one_recording
    osaved = ours[1].save_audio(tmp_path / "port.wav")
    jsaved = theirs[1].save_audio(tmp_path / "jax.wav")
    assert np.array_equal(osaved.load_audio(), ours[1].load_audio())
    assert not osaved.has_features and set(osaved.custom) == {"embedding"}
    assert np.array_equal(osaved.load_embedding(), ours[1].load_embedding())
    assert jsaved.has_features and set(jsaved.custom) == {"labels", "embedding"}
    assert not np.array_equal(jsaved.load_features(), ours[1].load_features())
    assert np.array_equal(jsaved.load_features(), ours[0].features.load(start=0.0, duration=1.0))
    assert not np.array_equal(jsaved.load_labels(), ours[1].load_labels())
    first = ours[0].save_audio(tmp_path / "first.wav")
    assert not first.has_features  # 0.2 s into the recording: dropped as well
