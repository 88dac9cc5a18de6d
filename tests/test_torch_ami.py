"""
The port's AMI recipe (lhotse_tpu_torch.recipes.ami) against the JAX
package's on the fixture layouts of tests/test_recipes_tranche16.py and
tests/test_recipes.py (headsets, the microphone array, the headset mix and
the beamformed array, made from a numpy seed), and the multi-channel
meeting path as a whole at a small size: an AMI corpus of two 20 s
train meetings (and one each for dev and test) with a 4-channel array → ``prepare_ami(mic="mdm")`` and
``prepare_ami(mic="ihm")`` → ``CutSet.from_manifests`` (MultiCuts) →
whole-session features → ``trim_to_supervisions`` → ``to_mono`` →
``SimpleCutSampler`` → ``K2SpeechRecognitionDataset`` with
``OnTheFlyFeatures`` → an AdamW step, against the same chain in the JAX
package.

Written ``.jsonl.gz`` manifests are compared after decompression, since a
gzip header carries its write time. Features are held to the JAX fbank
layer's kernel route computed with its XLA ops: 5e-5 for the stored log-mel
(the kernel's bound), 1e-4 for the on-the-fly chain (the feature budget).
"""
import gzip
import json
import logging
import shutil
import zipfile

import numpy as np
import pytest
import torch

import lhotse_tpu as J
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.sampling import SimpleCutSampler as JSimple
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi import layers as jl
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import ami as jami
from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet, MonoCut, MultiCut
from lhotse_tpu_torch.dataset import SimpleCutSampler
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.features.io import NumpyFilesWriter
from lhotse_tpu_torch.recipes import ami as pami
from lhotse_tpu_torch.supervision import SupervisionSet

SR = 16000
LOGMEL_TOL = 5e-5  # stored session features vs the JAX layer's kernel route; measured 4.1e-5
FEATURE_TOL = 1e-4  # the on-the-fly chain vs the JAX layer's kernel route; measured 2.8e-5
MICS = ("ihm", "mdm", "sdm", "ihm-mix", "mdm8-bf")


def _signal(rng, seconds, turns):
    """A 0.01 noise floor with a tone burst per speaker turn (start, end,
    frequency): the meeting corpus of chip_smoke.py's phase 15 in small."""
    n = int(seconds * SR)
    x = 0.01 * rng.standard_normal(n)
    for start, end, freq in turns:
        lo, hi = int(start * SR), int(end * SR)
        t = np.arange(hi - lo) / SR
        x[lo:hi] += 0.2 * np.sin(2 * np.pi * freq * t) * np.hanning(hi - lo)
    return x.astype(np.float32)


SPEAKERS = (("A", "MEE0{}", 0, 180.0), ("B", "FEE1{}", 1, 310.0))
TURNS = {  # per speaker: (start, end, words)
    "A": [(1.0, 4.0, [(1.1, 1.5, "hello"), (1.6, 2.2, "there"), (2.2, 2.2, "."),
                      (2.5, 3.5, "okay")]),
          (8.0, 12.0, [(8.2, 9.0, "so"), (9.1, 11.8, "anyway")])],
    "B": [(3.5, 6.5, [(3.6, 4.4, "mm"), (4.6, 5.4, "hmm"), (5.5, 6.4, "right")]),
          (13.0, 17.0, [(13.1, 14.0, "uh"), (14.2, 16.8, "huh")])],
}


def _ami_corpus(root, meetings, seconds=10.0, array_channels=4, seed=1234):
    """An AMI tree (tests/test_recipes.py::_ami_tree): each meeting's two
    headsets, ``array_channels`` channels of Array1, the headset mix and the
    beamformed array under ``wav_db``, and the NXT annotations (meetings.xml,
    per-speaker segments and words, with a full stop, overlapping turns and
    a kaldi-normalised interjection) under ``ami_public_manual_1.6.2``."""
    rng = np.random.default_rng(seed)
    ann = root / "ami_public_manual_1.6.2"
    for sub in ("corpusResources", "segments", "words"):
        (ann / sub).mkdir(parents=True, exist_ok=True)
    meetings_xml = ['<?xml version="1.0"?>', "<meetings>"]
    for mi, meet in enumerate(meetings):
        audio_dir = root / "wav_db" / meet / "audio"
        audio_dir.mkdir(parents=True)
        turns = {spk: [(s, e, freq * (1 + 0.05 * mi)) for s, e, _ in TURNS[spk] if e <= seconds]
                 for spk, _, _, freq in SPEAKERS}
        for spk, _, ch, _ in SPEAKERS:
            write_wav(str(audio_dir / f"{meet}.Headset-{ch}.wav"),
                      _signal(rng, seconds, turns[spk]), SR)
        both = turns["A"] + turns["B"]
        for k in range(1, array_channels + 1):
            write_wav(str(audio_dir / f"{meet}.Array1-0{k}.wav"), _signal(rng, seconds, both), SR)
        write_wav(str(audio_dir / f"{meet}.Mix-Headset.wav"), _signal(rng, seconds, both), SR)
        bf = root / "wav_db" / "beamformed" / meet
        bf.mkdir(parents=True)
        write_wav(str(bf / f"{meet}_MDM8.wav"), _signal(rng, seconds, both), SR)
        meetings_xml.append(f'  <meeting observation="{meet}">')
        for agent, name, ch, _ in SPEAKERS:
            meetings_xml.append(
                f'    <speaker nxt_agent="{agent}" global_name="{name.format(mi)}" channel="{ch}"/>')
            segs = [f'  <segment transcriber_start="{s}" transcriber_end="{e}"/>'
                    for s, e, _ in TURNS[agent] if e <= seconds]
            (ann / "segments" / f"{meet}.{agent}.segments.xml").write_text(
                '<?xml version="1.0"?>\n<segmentation>\n' + "\n".join(segs) + "\n</segmentation>")
            words = [
                f'  <w starttime="{ws}" endtime="{we}"'
                + (' punc="true"' if w == "." else "") + f">{w}</w>"
                for s, e, ws_ in TURNS[agent] if e <= seconds for ws, we, w in ws_]
            (ann / "words" / f"{meet}.{agent}.words.xml").write_text(
                '<?xml version="1.0"?>\n<words>\n' + "\n".join(words) + "\n</words>")
        meetings_xml.append("  </meeting>")
    meetings_xml.append("</meetings>")
    (ann / "corpusResources" / "meetings.xml").write_text("\n".join(meetings_xml))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One meeting per full-corpus partition (ES2002a train, ES2011a dev,
    ES2004a test), 10 s each."""
    return _ami_corpus(tmp_path_factory.mktemp("ami"), ["ES2002a", "ES2011a", "ES2004a"])


def _dicts(manifest) -> list:
    return [item.to_dict() for item in manifest]


def _as_dicts(manifests) -> dict:
    return {part: {k: _dicts(m) for k, m in pair.items()} for part, pair in manifests.items()}


def _decompressed(directory) -> dict:
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(directory.glob("*.jsonl.gz"))}


@pytest.mark.parametrize("mic", MICS)
@pytest.mark.parametrize("kwargs", [
    dict(), dict(partition="scenario-only", normalize_text="upper"),
    dict(max_words_per_segment=2, merge_consecutive=True, keep_punctuation=True),
    dict(normalize_text="none")])
def test_prepare_ami_equals_jax(corpus, tmp_path, mic, kwargs):
    ours = pami.prepare_ami(corpus, output_dir=tmp_path / "ours", mic=mic, **kwargs)
    theirs = jami.prepare_ami(corpus, output_dir=tmp_path / "jax", mic=mic, **kwargs)
    assert _as_dicts(ours) == _as_dicts(theirs)
    written = _decompressed(tmp_path / "ours")
    assert written == _decompressed(tmp_path / "jax") and len(written) == 6
    for pair in ours.values():
        assert type(pair["recordings"]) is RecordingSet
        assert type(pair["supervisions"]) is SupervisionSet
    train = ours["train"]
    if kwargs.get("partition") == "scenario-only":
        return
    (rec,) = list(train["recordings"])
    assert rec.id == "ES2002a"
    assert rec.num_channels == {"ihm": 2, "mdm": 4}.get(mic, 1)
    sups = list(train["supervisions"])
    assert len(sups) > 0
    if mic == "ihm":
        assert {s.channel for s in sups} == {0, 1}
        assert [s.channels for s in rec.sources] == [[0], [1]]
    else:
        assert all(s.channel == rec.channel_ids for s in sups)


def test_prepare_ami_text_and_alignment(corpus, tmp_path):
    """The checks of tests/test_recipes.py::test_prepare_ami_ihm on the port."""
    manifests = pami.prepare_ami(corpus, mic="ihm", partition="full-corpus", normalize_text="kaldi")
    sups = list(manifests["train"]["supervisions"])
    a_sups = [s for s in sups if s.speaker == "MEE00"]
    b_sups = [s for s in sups if s.speaker == "FEE10"]
    assert len(a_sups) == 2 and len(b_sups) == 1  # A splits at the full stop
    assert a_sups[0].text == "HELLO THERE" and a_sups[0].channel == 0 and b_sups[0].channel == 1
    assert b_sups[0].text == "MM HMM RIGHT"
    assert pami.normalize_text_ami("mm hmm", "kaldi") == "MM-HMM"
    assert [w.symbol for w in a_sups[0].alignment["word"]] == ["HELLO", "THERE"]
    assert a_sups[0].gender == "M" and b_sups[0].gender == "F"


def test_prepare_ami_reads_annotation_zip_and_separate_dir(tmp_path):
    """The layout of tests/test_recipes_tranche16.py: annotations given as a
    directory of their own, or as the zip in the data directory."""
    root = _ami_corpus(tmp_path / "ami", ["ES2011a", "ES2002a", "ES2004a"], seconds=5.0)
    ann = root / "ami_public_manual_1.6.2"
    ours = pami.prepare_ami(root / "wav_db", annotations_dir=ann, mic="mdm")
    theirs = jami.prepare_ami(root / "wav_db", annotations_dir=ann, mic="mdm")
    assert _as_dicts(ours) == _as_dicts(theirs)
    assert [r.id for r in ours["dev"]["recordings"]] == ["ES2011a"]
    zipped = tmp_path / "zipped"
    shutil.copytree(root / "wav_db", zipped / "wav_db")
    with zipfile.ZipFile(zipped / "ami_public_manual_1.6.2.zip", "w") as z:
        for p in sorted(ann.rglob("*.xml")):
            z.write(p, p.relative_to(ann))
    from_zip = pami.prepare_ami(zipped, mic="mdm")
    moved = json.loads(json.dumps(_as_dicts(from_zip)).replace(str(zipped), str(root)))
    assert moved == _as_dicts(ours)


@pytest.mark.parametrize("bad", ["mic", "partition", "no annotations"])
def test_prepare_ami_refuses(tmp_path, bad):
    (tmp_path / "empty").mkdir()
    kwargs = {"mic": dict(mic="xyz"), "partition": dict(partition="xyz"),
              "no annotations": {}}[bad]
    for prepare in (pami.prepare_ami, jami.prepare_ami):
        with pytest.raises(AssertionError if bad != "no annotations" else ValueError):
            prepare(tmp_path / "empty", **kwargs)


def test_split_segment_and_normalization_equal_jax():
    words = [
        (0.0, 0.5, "one"), (0.6, 1.0, "two"), (1.0, 1.0, "."), (1.2, 1.5, "three"),
        (1.6, 2.0, "four"), (2.1, 2.5, "five"), (2.5, 2.5, ","), (2.6, 3.0, "six")]
    for kwargs in [dict(), dict(max_words_per_segment=3), dict(max_words_per_segment=3,
                   merge_consecutive=True), dict(keep_punctuation=True)]:
        assert pami.split_segment(words, **kwargs) == jami.split_segment(words, **kwargs)
    for text in ["mm hmm o k", "Uh Huh, O_K!", "  spaced   out  "]:
        for norm in ("none", "upper", "kaldi"):
            assert pami.normalize_text_ami(text, norm) == jami.normalize_text_ami(text, norm)
    assert pami.MICS == jami.MICS and pami.PARTITIONS == jami.PARTITIONS
    assert not hasattr(pami, "download_ami")


# -- the meeting path, small, through both packages ------------------------------------------


class _JaxKernelRoute:
    """The default JAX fbank layer's kernel route (what it computes on a TPU)
    with its XLA ops: frames of the symmetric-padded audio through the
    folded matrices, power, mel, log (tests/test_torch_layers.py)."""

    def __init__(self):
        self.layer = jl.Wav2LogFilterBank()

    def __call__(self, x):
        import jax.numpy as jnp
        from lhotse_tpu.ops import fbank as jops

        Mc, Ms, fb, n_mels = self.layer._fused_matrices()
        frames = jops.frame_signal(jnp.asarray(x), 400, 160, self.layer.wav2win.snip_edges)
        return np.asarray(
            jops.mel_fbank_from_power(jops.power_spectrum_gemm(frames, Mc, Ms), fb[:, :n_mels]))


@pytest.fixture(scope="module")
def meetings(tmp_path_factory):
    """Two 20 s train meetings, and one each for the dev and test splits,
    which ``prepare_ami`` requires to be non-empty."""
    return _ami_corpus(
        tmp_path_factory.mktemp("meetings"), ["ES2002a", "ES2002b", "ES2011a", "ES2004a"],
        seconds=20.0)


def _slice(pkg, corpus, workdir, mic):
    """prepare_ami → from_manifests → trim_to_supervisions → to_mono → the
    sampler's first batch through the dataset, in one package."""
    if pkg == "port":
        prepare, CS = pami.prepare_ami, CutSet
        dataset = K2SpeechRecognitionDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
        sampler_cls = SimpleCutSampler
    else:
        prepare, CS = jami.prepare_ami, J.CutSet
        # Features on the JAX side come from its layer's kernel route below;
        # the dataset gives the supervisions' frames.
        dataset = JDataset(
            return_cuts=True, input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))))
        sampler_cls = JSimple
    train = prepare(corpus, output_dir=workdir / mic, mic=mic)["train"]
    sessions = CS.from_manifests(**train)
    trimmed = sessions.trim_to_supervisions(
        keep_overlapping=False, keep_all_channels=mic == "mdm").to_eager()
    monos = CS.from_cuts(m for c in trimmed for m in (c.to_mono() if mic == "mdm" else [c]))
    sampler = sampler_cls(monos, max_duration=30.0, shuffle=True, seed=0)
    batch = dataset[next(iter(sampler))]
    return sessions, trimmed, monos, batch


@pytest.mark.parametrize("mic", ["mdm", "ihm"])
def test_meeting_path_equals_jax(meetings, tmp_path, mic):
    sessions, trimmed, monos, batch = _slice("port", meetings, tmp_path / "ours", mic)
    jsessions, jtrimmed, jmonos, jbatch = _slice("jax", meetings, tmp_path / "jax", mic)
    assert _decompressed(tmp_path / "ours" / mic) == _decompressed(tmp_path / "jax" / mic)
    assert {type(c) for c in sessions} == {MultiCut}
    assert [c.channel for c in sessions] == ([[0, 1, 2, 3]] * 2 if mic == "mdm" else [[0, 1]] * 2)
    for ours, theirs in ((sessions, jsessions), (trimmed, jtrimmed), (monos, jmonos)):
        assert _dicts(ours) == _dicts(theirs)
    # 5 supervisions per meeting (speaker A's first turn splits at its full
    # stop): MultiCuts of 4 channels, or MonoCuts on the speaker's headset.
    assert len(trimmed) == 10
    assert {type(c) for c in trimmed} == ({MultiCut} if mic == "mdm" else {MonoCut})
    assert len(monos) == (40 if mic == "mdm" else 10) and {type(c) for c in monos} == {MonoCut}
    route = _JaxKernelRoute()
    jcuts = jbatch["supervisions"]["cut"]
    assert [c.id for c in batch["supervisions"]["cut"]] == [c.id for c in jcuts]
    for key in ("sequence_idx", "start_frame", "num_frames"):
        np.testing.assert_array_equal(batch["supervisions"][key], jbatch["supervisions"][key])
    worst = 0.0
    for i, cut in enumerate(jcuts):
        want = route(cut.load_audio())[0]
        assert batch["inputs"][i].shape[0] >= want.shape[0]
        worst = max(worst, float(np.abs(batch["inputs"][i, : want.shape[0]] - want).max()))
    assert worst <= FEATURE_TOL, worst


def test_session_features_and_trimmed_reads(meetings, tmp_path):
    """Whole-session features of the MDM MultiCuts: one (4, T, 80) matrix per
    session, each channel at the kernel's bound from the JAX layer's kernel
    route; trimmed MultiCuts read their slice of it."""
    sessions = CutSet.from_manifests(**pami.prepare_ami(meetings, mic="mdm")["train"])
    featured = sessions.compute_and_store_features(
        Fbank(FbankConfig(device="cpu")), tmp_path / "feats", storage_type=NumpyFilesWriter)
    route = _JaxKernelRoute()
    for cut in featured:
        feats = cut.load_features()
        assert feats.shape == (4, cut.num_frames, 80) and cut.features.channels == [0, 1, 2, 3]
        want = route(cut.load_audio())
        assert np.abs(feats - want).max() <= LOGMEL_TOL
    trimmed = featured.trim_to_supervisions(
        keep_overlapping=False, keep_all_channels=True).to_eager()
    assert len(trimmed) == 10
    by_recording = {c.recording_id: c.load_features() for c in featured}
    for cut in trimmed:
        session = by_recording[cut.recording_id]
        first = round(cut.start / cut.frame_shift)
        np.testing.assert_array_equal(
            cut.load_features(), session[:, first:first + cut.num_frames])
        np.testing.assert_array_equal(
            cut.load_features(channel=2), session[2:3, first:first + cut.num_frames])


def test_meeting_batch_adamw_step_matches_optax(meetings, tmp_path):
    """The AdamW step of a narrow 2-layer encoder on the first MDM batch,
    against ``optax.adamw`` in the JAX package (tests/test_torch_encoder.py's
    bounds)."""
    import jax

    from lhotse_tpu.models import encoder as JE
    from lhotse_tpu_torch.models import encoder as PE
    from test_torch_encoder import (
        ADAMW_NEAR_EPS_LR, ADAMW_WELL_ATOL, ADAMW_WELL_RTOL, LOSS_RTOL, _configs, _port, _t,
        _update_errs)

    *_, batch = _slice("port", meetings, tmp_path, "mdm")
    feats = batch["inputs"]
    lens = batch["supervisions"]["num_frames"]
    jcfg, _ = _configs(torch.float32)
    params = JE.init_params(jax.random.PRNGKey(0), jcfg)
    j_init, j_step = JE.make_adamw_train_step(jcfg, lr=1e-3)
    p_init, p_step = PE.make_adamw_train_step(lr=1e-3)
    enc = _port(params, torch.float32)
    start, state, opt = params, j_init(params), p_init(enc)
    key = jax.random.PRNGKey(5)
    mask = _t(jax.random.bernoulli(key, jcfg.mask_prob, feats.shape[:2]))
    params, state, want = j_step(params, state, feats, lens, key)
    got = p_step(enc, opt, _t(feats), _t(lens).long(), mask)
    assert np.isfinite(float(got))
    first_grads = {n: p.grad.abs().numpy().copy() for n, p in enc.named_parameters()}
    assert abs(float(got) - float(want)) <= LOSS_RTOL[torch.float32] * float(want)
    well_abs, well_rel, near_abs = _update_errs(start, params, enc, first_grads)
    assert well_abs <= ADAMW_WELL_ATOL and well_rel <= ADAMW_WELL_RTOL, (well_abs, well_rel)
    assert near_abs <= ADAMW_NEAR_EPS_LR * 1e-3


def test_leftover_annotations_warn_in_both(tmp_path, caplog):
    """A meeting without audio leaves its annotations unused; a headset file
    without an annotated speaker warns in both packages."""
    root = _ami_corpus(tmp_path / "ami", ["ES2002a", "ES2011a", "ES2004a"], seconds=5.0)
    extra = root / "wav_db" / "ES2002a" / "audio" / "ES2002a.Headset-2.wav"
    write_wav(str(extra), np.zeros(5 * SR, np.float32), SR)
    with caplog.at_level(logging.WARNING):
        ours = pami.prepare_ami(root, mic="ihm")
    messages = [m for m in caplog.messages if "No annotation" in m]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        theirs = jami.prepare_ami(root, mic="ihm")
    assert messages and messages == [m for m in caplog.messages if "No annotation" in m]
    assert _as_dicts(ours) == _as_dicts(theirs)
