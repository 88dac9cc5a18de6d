"""
The port's TTS, tagging and unsupervised task datasets and the collation
they build on (lhotse_tpu_torch.dataset: ``TokenCollater``,
``collate_custom_field``, ``SpeechSynthesisDataset``/``validate_for_tts``,
``AudioTaggingDataset``, ``UnsupervisedDataset``,
``UnsupervisedWaveformDataset``, ``DynamicUnsupervisedDataset``,
``RecordingChunkIterableDataset``, ``audio_chunk_collate`` and
``audio_chunk_worker_init_fn``) against the JAX package's on the same cuts.

Tokens, vocabularies, text, labels, audio and chunk times are compared
exactly; stored features (one JAX-written ``lilcom_chunky`` archive, read by
both packages) exactly; features extracted on the fly within
``EXTRACTOR_TOL`` of the JAX extractors' device route (XLA on the CPU). The
chunk dataset runs without worker processes: the worker sharding is tested
by faking torch's worker info, as the sampler tests fake the rank.
"""
import copy
import types
import warnings

import numpy as np
import pytest
import torch.utils.data

import lhotse_tpu as J
from lhotse_tpu.audio.wavio import write_wav as jwrite_wav
from lhotse_tpu.dataset import audio_tagging as jtagging
from lhotse_tpu.dataset import collation as jcollation
from lhotse_tpu.dataset import speech_synthesis as jtts
from lhotse_tpu.dataset import unsupervised as junsup
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import (
    AudioTaggingDataset, DynamicUnsupervisedDataset, RecordingChunkIterableDataset,
    SpeechSynthesisDataset, TokenCollater, UnsupervisedDataset, UnsupervisedWaveformDataset,
    audio_chunk_collate, audio_chunk_worker_init_fn, collate_custom_field, validate_for_tts)
from lhotse_tpu_torch.dataset.input_strategies import AudioSamples, OnTheFlyFeatures
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.utils import fastcopy

SR = 16000
# The extractor's bound against the JAX device route (tests/test_torch_precomputed.py).
EXTRACTOR_TOL = 3e-4
EVENTS = ("Speech", "Music", "Speech;Music", "Dog")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six WAV cuts of seeded noise (1-2.25 s), one supervision each (a
    text over a small alphabet, a speaker, an ``audio_event``), written by
    the JAX package; their fbank features in a JAX-written ``lilcom_chunky``
    archive. Returns the directory with ``cuts.jsonl`` and ``feats.jsonl``."""
    root = tmp_path_factory.mktemp("generative")
    rng = np.random.RandomState(7)
    cuts = []
    for i in range(6):
        path = root / f"r{i}.wav"
        jwrite_wav(str(path), (rng.randn(SR + i * 2000) * 0.1).astype(np.float32), SR)
        cut = J.Recording.from_file(path).to_cut()
        cut.supervisions = [J.SupervisionSegment(
            id=f"s{i}", recording_id=cut.recording_id, start=0.05,
            duration=round(cut.duration - 0.1, 2), text=f"utt {i} say {'abc'[i % 3] * (i + 1)}",
            speaker=f"spk{i % 2}", custom={"audio_event": EVENTS[i % len(EVENTS)]})]
        cuts.append(cut)
    cuts = J.CutSet.from_cuts(cuts)
    cuts.to_file(root / "cuts.jsonl")
    cuts.compute_and_store_features(
        JFbank(), root / "feats", storage_type=J.LilcomChunkyWriter,
        progress_bar=False).to_file(root / "feats.jsonl")
    return root


def _both(corpus, name):
    return CutSet.from_file(corpus / name).to_eager(), J.CutSet.from_file(corpus / name).to_eager()


def _equal(got, want):
    """Batches equal key by key: arrays exactly (values and dtype), cuts by
    their dicts, the rest by ``==``."""
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
            assert got[key].dtype == value.dtype, key
        elif isinstance(value, dict):
            _equal(got[key], value)
        elif key in ("cut", "cuts"):
            assert [c.to_dict() for c in got[key]] == [c.to_dict() for c in value]
        elif isinstance(value, list) and value and isinstance(value[0], np.ndarray):
            assert len(got[key]) == len(value)
            for a, b in zip(got[key], value):
                np.testing.assert_array_equal(a, b)
        else:
            assert got[key] == value, key


# -- TokenCollater ---------------------------------------------------------------------------


@pytest.mark.parametrize("add_bos", [True, False])
@pytest.mark.parametrize("add_eos", [True, False])
def test_token_collater_equals_jax(corpus, add_bos, add_eos):
    cuts, jcuts = _both(corpus, "cuts.jsonl")
    ours = TokenCollater(cuts, add_bos=add_bos, add_eos=add_eos)
    theirs = jcollation.TokenCollater(jcuts, add_bos=add_bos, add_eos=add_eos)
    assert ours.idx2token == theirs.idx2token and ours.token2idx == theirs.token2idx
    assert ours.idx2token[:2] == ["<pad>", "<unk>"]
    tokens, lens = ours(cuts)
    jtokens, jlens = theirs(jcuts)
    for a, b in ((tokens, jtokens), (lens, jlens)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    texts = ours.inverse(tokens, lens)
    assert texts == theirs.inverse(jtokens, jlens) == [c.supervisions[0].text for c in cuts]


def test_token_collater_maps_unseen_characters_to_unk(corpus):
    cuts, jcuts = _both(corpus, "cuts.jsonl")
    ours = TokenCollater(cuts.subset(first=2), unk_symbol="<?>")
    theirs = jcollation.TokenCollater(jcuts.subset(first=2), unk_symbol="<?>")
    tokens, lens = ours(cuts)
    np.testing.assert_array_equal(tokens, theirs(jcuts)[0])
    assert (tokens == ours.token2idx["<?>"]).any()
    assert ours.inverse(tokens, lens)[-1] == theirs.inverse(*theirs(jcuts))[-1]


# -- collate_custom_field ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def custom(corpus, tmp_path_factory):
    """The cuts with custom fields: a fixed-size ``Array`` embedding, a
    ``TemporalArray`` of int16 labels of varying length, a second
    ``Recording`` and a plain number, stored with the JAX package."""
    root = tmp_path_factory.mktemp("custom")
    rng = np.random.default_rng(3)
    out = []
    with J.NumpyFilesWriter(root / "arrays") as writer:
        for i, cut in enumerate(J.CutSet.from_file(corpus / "cuts.jsonl")):
            emb = writer.store_array(f"{cut.id}-emb", rng.standard_normal(8).astype(np.float32))
            labels = writer.store_array(
                f"{cut.id}-lab", rng.integers(0, 50, size=(10 + 3 * i, 2)).astype(np.int16),
                frame_shift=0.04, temporal_dim=0)
            out.append(cut.with_custom("emb", emb).with_custom("labels", labels).with_custom(
                "noise", cut.recording).with_custom("weight", 0.5 + i))
    J.CutSet.from_cuts(out).to_file(root / "custom.jsonl")
    return root


@pytest.mark.parametrize("field,kwargs", [
    ("emb", {}), ("labels", dict(pad_value=-1)), ("labels", dict(pad_value=-1, pad_direction="left")),
    ("labels", dict(pad_value=7, pad_direction="both")), ("noise", {}), ("weight", {})])
def test_collate_custom_field_equals_jax(custom, field, kwargs):
    cuts, jcuts = _both(custom, "custom.jsonl")
    got = collate_custom_field(cuts, field, **kwargs)
    want = jcollation.collate_custom_field(jcuts, field, **kwargs)
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if field == "labels":
        assert got[0].dtype == np.int64 and got[1].tolist() == [10 + 3 * i for i in range(6)]


def test_collate_custom_field_defaults_and_refusals(custom):
    cuts, jcuts = _both(custom, "custom.jsonl")
    with pytest.warns(UserWarning, match="pad_value"):
        got = collate_custom_field(cuts, "labels")
    with pytest.warns(UserWarning, match="pad_value"):
        want = jcollation.collate_custom_field(jcuts, "labels")
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="pad_direction"):
        collate_custom_field(cuts, "labels", pad_value=0, pad_direction="middle")
    ragged = CutSet.from_cuts(
        [cuts[0], fastcopy(cuts[1], custom=dict(cuts[1].custom, emb=fastcopy(cuts[1].emb, shape=[4])))])
    with pytest.raises(AssertionError, match="different shapes"):
        collate_custom_field(ragged, "emb")


# -- SpeechSynthesisDataset ---------------------------------------------------------------------


def _with_tokens(cuts, collater, copy_):
    return cuts.__class__.from_cuts(
        copy_(c, custom=dict(c.custom or {}, tokens=collater.inverse(*collater(cuts.subset(cut_ids=[c.id])))[0].split()))
        for c in cuts)


@pytest.mark.parametrize("strategy", ["precomputed", "on_the_fly"])
def test_tts_equals_jax(corpus, strategy):
    cuts, jcuts = _both(corpus, "feats.jsonl" if strategy == "precomputed" else "cuts.jsonl")
    kw = dict(return_text=True, return_tokens=True, return_spk_ids=True, return_cuts=True)
    if strategy == "precomputed":
        ours, theirs = SpeechSynthesisDataset(**kw), jtts.SpeechSynthesisDataset(**kw)
    else:
        ours = SpeechSynthesisDataset(
            feature_input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))), **kw)
        theirs = jtts.SpeechSynthesisDataset(
            feature_input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))), **kw)
    cuts = _with_tokens(cuts, TokenCollater(cuts), fastcopy)
    jcuts = _with_tokens(jcuts, jcollation.TokenCollater(jcuts), J.utils.fastcopy)
    for ids in ([c.id for c in cuts][:2], [c.id for c in cuts][2:]):
        got, want = ours[cuts.subset(cut_ids=ids)], theirs[jcuts.subset(cut_ids=ids)]
        if strategy == "on_the_fly":
            np.testing.assert_allclose(got.pop("features"), want.pop("features"), rtol=0,
                                       atol=EXTRACTOR_TOL)
        _equal(got, want)
        assert got["text"] == [c.supervisions[0].text for c in cuts.subset(cut_ids=ids)]
        assert got["tokens"] == [list(t.split()) for t in got["text"]]
        assert got["audio"].ndim == 2 and len(got["speakers"]) == len(ids)


def test_tts_feature_transforms_and_refusal(corpus):
    cuts, jcuts = _both(corpus, "feats.jsonl")
    got = SpeechSynthesisDataset(feature_transforms=lambda f: f * 2)[cuts]
    want = jtts.SpeechSynthesisDataset(feature_transforms=lambda f: f * 2)[jcuts]
    _equal(got, want)
    two = CutSet.from_cuts([fastcopy(cuts[0], supervisions=cuts[0].supervisions * 2)])
    jtwo = J.CutSet.from_cuts([J.utils.fastcopy(jcuts[0], supervisions=jcuts[0].supervisions * 2)])
    with pytest.raises(AssertionError, match="single supervision"):
        validate_for_tts(two)
    with pytest.raises(AssertionError, match="single supervision"):
        jtts.validate_for_tts(jtwo)


# -- AudioTaggingDataset ------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["precomputed", "audio", "on_the_fly"])
def test_audio_tagging_equals_jax(corpus, strategy):
    cuts, jcuts = _both(corpus, "feats.jsonl" if strategy == "precomputed" else "cuts.jsonl")
    if strategy == "precomputed":
        ours, theirs = AudioTaggingDataset(return_cuts=True), jtagging.AudioTaggingDataset(return_cuts=True)
    elif strategy == "audio":
        ours = AudioTaggingDataset(return_cuts=True, input_strategy=AudioSamples())
        theirs = jtagging.AudioTaggingDataset(return_cuts=True, input_strategy=JAudioSamples())
    else:
        ours = AudioTaggingDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
        theirs = jtagging.AudioTaggingDataset(
            return_cuts=True, input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))))
    got, want = ours[cuts], theirs[jcuts]
    if strategy == "on_the_fly":
        np.testing.assert_allclose(got.pop("inputs"), want.pop("inputs"), rtol=0, atol=EXTRACTOR_TOL)
    _equal(got, want)
    events = got["supervisions"]["audio_event"]
    assert sorted(events) == sorted(EVENTS[i % len(EVENTS)] for i in range(6))


# -- the unsupervised datasets ----------------------------------------------------------------


def test_unsupervised_equals_jax(corpus):
    cuts, jcuts = _both(corpus, "feats.jsonl")
    got, want = UnsupervisedDataset()[cuts], junsup.UnsupervisedDataset()[jcuts]
    _equal(got, want)
    assert got["features"].shape[:2] == (6, max(c.num_frames for c in cuts))


@pytest.mark.parametrize("collate", [True, False])
def test_unsupervised_waveform_equals_jax(corpus, collate):
    cuts, jcuts = _both(corpus, "cuts.jsonl")
    got = UnsupervisedWaveformDataset(collate=collate)[cuts]
    want = junsup.UnsupervisedWaveformDataset(collate=collate)[jcuts]
    _equal(got, want)


def test_dynamic_unsupervised_equals_jax(corpus):
    cuts, jcuts = _both(corpus, "cuts.jsonl")
    got = DynamicUnsupervisedDataset(Fbank(FbankConfig(device="cpu")))[cuts]
    want = junsup.DynamicUnsupervisedDataset(JFbank(JFbankConfig(device="tpu")))[jcuts]
    assert got.shape == want.shape and got.dtype == want.dtype and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=EXTRACTOR_TOL)


def test_unsupervised_datasets_refuse_what_they_lack(corpus):
    cuts, jcuts = _both(corpus, "cuts.jsonl")
    with pytest.raises(AssertionError):
        UnsupervisedDataset()[cuts]
    with pytest.raises(AssertionError):
        junsup.UnsupervisedDataset()[jcuts]
    feats, jfeats = _both(corpus, "feats.jsonl")
    featured_only = CutSet.from_cuts(fastcopy(c, recording=None) for c in feats)
    with pytest.raises(AssertionError):
        UnsupervisedWaveformDataset()[featured_only]


# -- RecordingChunkIterableDataset (JAX's test_audio_chunk_dataset.py) ----------------------------


@pytest.fixture
def recordings(tmp_path):
    """Two mono WAV recordings (2.5 s and 1.0 s) of a sawtooth, written by
    the JAX package; returned as both packages' RecordingSets."""
    recs = []
    for i, dur in enumerate([2.5, 1.0]):
        path = tmp_path / f"r{i}.wav"
        jwrite_wav(str(path), (np.arange(int(SR * dur)) % 1000 / 1000.0 - 0.5).astype(np.float32), SR)
        recs.append(J.Recording.from_file(path, recording_id=f"rec{i}"))
    J.RecordingSet.from_recordings(recs).to_file(tmp_path / "recs.jsonl")
    return RecordingSet.from_file(tmp_path / "recs.jsonl"), J.RecordingSet.from_file(tmp_path / "recs.jsonl")


def _items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["recording_id"] == b["recording_id"]
        for key in ("begin_time", "end_time", "audio"):
            np.testing.assert_array_equal(a[key], b[key])
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype


def test_non_overlapping_chunks_cover_recording(recordings):
    recs, jrecs = recordings
    items = list(RecordingChunkIterableDataset(recs, chunk_size=1.0, chunk_shift=1.0))
    _items_equal(items, list(junsup.RecordingChunkIterableDataset(jrecs, chunk_size=1.0, chunk_shift=1.0)))
    by_rec = {}
    for it in items:
        by_rec.setdefault(it["recording_id"], []).append(it)
    assert (len(by_rec["rec0"]), len(by_rec["rec1"])) == (3, 1)
    np.testing.assert_array_equal(np.concatenate([c["audio"] for c in by_rec["rec0"]]),
                                  recs["rec0"].load_audio()[0])
    assert [float(c["begin_time"]) for c in by_rec["rec0"]] == [0.0, 1.0, 2.0]


def test_overlapping_chunks(recordings):
    recs, jrecs = recordings
    items = list(RecordingChunkIterableDataset(recs, chunk_size=1.0, chunk_shift=0.5))
    _items_equal(items, list(junsup.RecordingChunkIterableDataset(jrecs, chunk_size=1.0, chunk_shift=0.5)))
    chunks = [c for c in items if c["recording_id"] == "rec1"]
    assert len(chunks) == 2 and chunks[0]["audio"].shape[0] == SR and chunks[1]["audio"].shape[0] == SR // 2
    np.testing.assert_array_equal(chunks[0]["audio"][SR // 2:], chunks[1]["audio"])


def test_validation_rejects_multichannel(tmp_path, recordings):
    recs, jrecs = recordings
    stereo = tmp_path / "st.wav"
    jwrite_wav(str(stereo), np.zeros((2, SR), np.float32), SR)
    bad = RecordingSet.from_recordings(list(recs) + [RecordingSet.from_dir(tmp_path, "st.wav")[0]])
    with pytest.raises(AssertionError, match="single-channel"):
        RecordingChunkIterableDataset(bad, chunk_size=1.0, chunk_shift=1.0)
    memory = fastcopy(recs[0], sources=[fastcopy(recs[0].sources[0], type="memory", source=b"")])
    with pytest.raises(AssertionError, match="'file'"):
        RecordingChunkIterableDataset(RecordingSet.from_recordings([memory]), 1.0, 1.0)


def test_collate_pads_to_longest(recordings):
    recs, jrecs = recordings
    batch = audio_chunk_collate(list(RecordingChunkIterableDataset(recs, 1.0, 1.0)))
    want = junsup.audio_chunk_collate(list(junsup.RecordingChunkIterableDataset(jrecs, 1.0, 1.0)))
    _equal(batch, want)
    assert batch["audio"].shape == (4, SR) and batch["recording_id"] == ["rec0", "rec0", "rec0", "rec1"]
    np.testing.assert_allclose(batch["begin_time"], [0.0, 1.0, 2.0, 0.0])
    assert np.all(batch["audio"][2, SR // 2:] == 0.0)


def test_chunks_through_a_torch_loader_without_workers(recordings):
    recs, jrecs = recordings
    dataset = RecordingChunkIterableDataset(recs, chunk_size=1.0, chunk_shift=0.5)
    assert isinstance(dataset, torch.utils.data.IterableDataset)
    loader = torch.utils.data.DataLoader(
        dataset, batch_size=2, num_workers=0, collate_fn=audio_chunk_collate,
        worker_init_fn=audio_chunk_worker_init_fn)
    items = list(junsup.RecordingChunkIterableDataset(jrecs, chunk_size=1.0, chunk_shift=0.5))
    batches = list(loader)
    assert len(items) == 7 and len(batches) == 4
    for i, batch in enumerate(batches):
        _equal(batch, junsup.audio_chunk_collate(copy.deepcopy(items[2 * i: 2 * i + 2])))


def _fake_worker(monkeypatch, worker_id, num_workers, dataset):
    info = types.SimpleNamespace(id=worker_id, num_workers=num_workers, seed=worker_id, dataset=dataset)
    monkeypatch.setattr(torch.utils.data, "get_worker_info", lambda: info)


@pytest.mark.parametrize("num_workers", [1, 2, 3])
def test_worker_init_fn_shards_every_chunk_once(tmp_path, monkeypatch, num_workers):
    """Each (faked) worker's copy of the dataset keeps its share of the
    recordings: every chunk comes out exactly once across the workers, and
    the shards concatenate to the unsharded order."""
    rng = np.random.default_rng(5)
    recs = []
    for i in range(5):
        path = tmp_path / f"s{i}.wav"
        jwrite_wav(str(path), (0.1 * rng.standard_normal(int(SR * (1.5 + 0.5 * i)))).astype(np.float32), SR)
        recs.append(J.Recording.from_file(path))
    J.RecordingSet.from_recordings(recs).to_file(tmp_path / "recs.jsonl")
    dataset = RecordingChunkIterableDataset(RecordingSet.from_file(tmp_path / "recs.jsonl"), 1.0, 0.5)
    whole = [(c["recording_id"], float(c["begin_time"])) for c in dataset]
    shards = []
    for worker_id in range(num_workers):
        copy_ = copy.deepcopy(dataset)
        _fake_worker(monkeypatch, worker_id, num_workers, copy_)
        audio_chunk_worker_init_fn(worker_id)
        shards.append([(c["recording_id"], float(c["begin_time"])) for c in copy_])
    assert [c for shard in shards for c in shard] == whole
    assert len(set(whole)) == len(whole)
    assert all(shards) and (dataset.start, dataset.end) == (0, 5)


def test_worker_init_fn_outside_a_worker_and_the_jax_fault(recordings, monkeypatch):
    """Outside a worker the init function leaves the dataset alone. In a
    worker the JAX function reads the package's own ``WorkerInfo``, which
    carries no dataset, and raises ``AttributeError`` (ROADMAP C1)."""
    recs, jrecs = recordings
    dataset = RecordingChunkIterableDataset(recs, 1.0, 1.0)
    monkeypatch.setattr(torch.utils.data, "get_worker_info", lambda: None)
    audio_chunk_worker_init_fn(0)
    assert (dataset.start, dataset.end) == (0, 2)
    jdataset = junsup.RecordingChunkIterableDataset(jrecs, 1.0, 1.0)
    _fake_worker(monkeypatch, 0, 2, jdataset)
    with pytest.raises(AttributeError, match="dataset"):
        junsup.audio_chunk_worker_init_fn(0)
    _fake_worker(monkeypatch, 1, 2, dataset)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        audio_chunk_worker_init_fn(1)
    assert (dataset.start, dataset.end) == (1, 2)
