"""
The port's far-field meeting recipes (lhotse_tpu_torch.recipes ``aishell4``,
``ali_meeting``, ``icsi``, ``notsofar1``, ``libricss``, ``chime6``,
``dipco`` and the TextGrid reader) against the JAX package's, on the
fixture layouts of tests/test_recipes.py (ICSI), tests/test_recipes_tranche2.py
(DiPCo, AliMeeting, AISHELL-4, LibriCSS), tests/test_recipes_tranche3.py
(NOTSOFAR-1) and tests/test_recipes_tranche17.py (CHiME-6), and on wider
layouts at each corpus's published channel counts and file names (made from
a numpy seed), parametrised over mics and parts; and one recipe as a slice:
an 8-channel AISHELL-4 session → ``prepare_aishell4`` →
``CutSet.from_manifests`` → ``trim_to_supervisions(keep_all_channels=True)``
→ ``to_mono`` → ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures``,
within ``EXTRACTOR_TOL`` (tests/test_torch_recipes.py) of the JAX chain
with its extractor's device route.

Manifests are compared as dicts and written ``.jsonl.gz`` files after
decompression (a gzip header carries its write time), with each package's
output directory replaced by one placeholder where a recipe writes audio
there (ICSI's ``save_to_wav``).
"""
import gzip
import json
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac
from lhotse_tpu.audio.sphio import write_sph
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.sampling import SimpleCutSampler as JSimple
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import aishell4 as jaishell4
from lhotse_tpu.recipes import ali_meeting as jali
from lhotse_tpu.recipes import chime6 as jchime6
from lhotse_tpu.recipes import dipco as jdipco
from lhotse_tpu.recipes import icsi as jicsi
from lhotse_tpu.recipes import libricss as jlibricss
from lhotse_tpu.recipes import notsofar1 as jnotsofar1
from lhotse_tpu.recipes import textgrid as jtextgrid
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.cut import CutSet, MonoCut, MultiCut
from lhotse_tpu_torch.dataset import SimpleCutSampler
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import aishell4 as paishell4
from lhotse_tpu_torch.recipes import ali_meeting as pali
from lhotse_tpu_torch.recipes import chime6 as pchime6
from lhotse_tpu_torch.recipes import dipco as pdipco
from lhotse_tpu_torch.recipes import icsi as picsi
from lhotse_tpu_torch.recipes import libricss as plibricss
from lhotse_tpu_torch.recipes import notsofar1 as pnotsofar1
from lhotse_tpu_torch.recipes import textgrid as ptextgrid
from lhotse_tpu_torch.utils import fix_random_seed

SR = 16000
EXTRACTOR_TOL = 3e-4  # tests/test_torch_recipes.py:41


def _noise(seconds, seed, channels=1):
    """tests/test_recipes*.py::_wav's signal: 0.1 white noise from RandomState(seed)."""
    return (np.random.RandomState(seed).randn(channels, int(seconds * SR)) * 0.1).astype(np.float32)


def _wav(path, seconds=1.0, seed=0, channels=1):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, _noise(seconds, seed, channels), SR)


def _flac(path, seconds=1.0, seed=0, channels=1):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_flac(path, _noise(seconds, seed, channels), SR)


def _sph(path, seconds=1.0, seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_sph(path, _noise(seconds, seed), SR)


# tests/test_recipes_tranche2.py:337
TEXTGRID = """File type = "ooTextFile"
Object class = "TextGrid"
xmin = 0
xmax = 2
tiers? <exists>
size = 1
item []:
    item [1]:
        class = "IntervalTier"
        name = "{tier}"
        xmin = 0
        xmax = 2
        intervals: size = 2
        intervals [1]:
            xmin = 0.25
            xmax = 1.0
            text = "你好"
        intervals [2]:
            xmin = 1.0
            xmax = 2.0
            text = ""
"""


def textgrid(tiers, xmax):
    """A long-format TextGrid of interval tiers: {name: [(start, end, text)]}."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "xmin = 0",
             f"xmax = {xmax}", "tiers? <exists>", f"size = {len(tiers)}", "item []:"]
    for k, (name, intervals) in enumerate(tiers.items(), 1):
        lines += [f"    item [{k}]:", '        class = "IntervalTier"', f'        name = "{name}"',
                  "        xmin = 0", f"        xmax = {xmax}",
                  f"        intervals: size = {len(intervals)}"]
        for j, (start, end, text) in enumerate(intervals, 1):
            lines += [f"        intervals [{j}]:", f"            xmin = {start}",
                      f"            xmax = {end}", f'            text = "{text}"']
    return "\n".join(lines) + "\n"


# -- layouts ------------------------------------------------------------------------------


def aishell4_tree(root, layout="jax", channels=8, seconds=6.0):
    """``jax``: tests/test_recipes_tranche2.py:374 (one test session);
    ``array``: a train_L session of ``channels`` channels with two speakers'
    tiers, a test session, and a session without its TextGrid (skipped)."""
    if layout == "jax":
        _flac(root / "test" / "wav" / "L_R001S01C01.flac", seconds=2.0, seed=81)
        (root / "test" / "TextGrid").mkdir(parents=True)
        (root / "test" / "TextGrid" / "L_R001S01C01.TextGrid").write_text(TEXTGRID.format(tier="1"))
        return root
    for part, session, seed in (("train_L", "L_R003S01C02", 82), ("test", "M_R004S02C01", 83)):
        _flac(root / part / "wav" / f"{session}.flac", seconds=seconds, seed=seed, channels=channels)
        (root / part / "TextGrid").mkdir(parents=True, exist_ok=True)
        (root / part / "TextGrid" / f"{session}.TextGrid").write_text(textgrid({
            "1": [(0.3, 1.7, "今天<sil>开会，"), (1.7, 2.0, ""), (3.1, 4.4, "ｂｔ好的")],
            "2": [(1.5, 2.9, "嗯<%>对"), (4.2, 5.6, "ａｂｃ 再见")]}, seconds))
    _flac(root / "train_L" / "wav" / "L_R003S02C01.flac", seconds=1.0, seed=84)
    return root


def ali_meeting_tree(root, seconds=3.0):
    """tests/test_recipes_tranche2.py:361 (Train far, 8 channels, tier
    F_SPK0093), with its near-field headset file and an Eval split nested
    under Eval_Ali/ with two speakers."""
    base = root / "Train_Ali_far"
    _wav(base / "audio_dir" / "R0001_M0001.wav", seconds=seconds, seed=80, channels=8)
    (base / "textgrid_dir").mkdir(parents=True)
    (base / "textgrid_dir" / "R0001_M0001.TextGrid").write_text(TEXTGRID.format(tier="F_SPK0093"))
    near = root / "Train_Ali_near"
    _wav(near / "audio_dir" / "R0001_M0001_F_SPK0093.wav", seconds=seconds, seed=81)
    (near / "textgrid_dir").mkdir(parents=True)
    (near / "textgrid_dir" / "R0001_M0001_F_SPK0093.TextGrid").write_text(
        TEXTGRID.format(tier="SPK0093"))
    eval_far = root / "Eval_Ali" / "Eval_Ali_far"
    _wav(eval_far / "audio_dir" / "R8001_M8004_MS801.wav", seconds=seconds, seed=82, channels=8)
    (eval_far / "textgrid_dir").mkdir(parents=True)
    (eval_far / "textgrid_dir" / "R8001_M8004.TextGrid").write_text(textgrid({
        "R8001_M8004_M_SPK8013": [(0.2, 1.1, "<sil>好的，ｋ歌"), (1.1, 1.4, "")],
        "R8001_M8004_F_SPK8014": [(1.0, 2.5, "我觉得`可以")]}, seconds))
    eval_near = root / "Eval_Ali" / "Eval_Ali_near"
    for k, (gender, spk) in enumerate((("M", "8013"), ("F", "8014"))):
        stem = f"R8001_M8004_{gender}_SPK{spk}"
        _wav(eval_near / "audio_dir" / f"{stem}.wav", seconds=seconds, seed=83 + k)
        (eval_near / "textgrid_dir").mkdir(parents=True, exist_ok=True)
        (eval_near / "textgrid_dir" / f"{stem}.TextGrid").write_text(
            textgrid({f"SPK{spk}": [(0.2 + k, 1.1 + k, "嗯<%>对")]}, seconds))
    return root


ICSI_MEETINGS = ("Bdb001", "Bmr021", "Bmr013")  # one per partition: train, dev, test


def _icsi_transcripts(trans, channels, participants):
    """preambles.mrt and the Segments/Words XML of tests/test_recipes.py:645."""
    (trans / "Segments").mkdir(parents=True)
    (trans / "Words").mkdir()
    preambles = ['<?xml version="1.0"?>', "<Meetings>"]
    for mi, meet in enumerate(ICSI_MEETINGS):
        preambles += [f'  <Meeting Session="{meet}">', "    <Preamble>", "      <Channels>"]
        preambles += [f'        <Channel Name="{c}"/>' for c in channels]
        preambles += ["      </Channels>", "      <Participants>"]
        preambles += [f'        <Participant Name="{name.format(mi)}" Channel="{ch}"/>'
                      for name, ch in participants]
        preambles += ["      </Participants>", "    </Preamble>", "  </Meeting>"]
        turns = [("A", participants[0][0].format(mi), 1.0, 4.0,
                  [(1.1, 1.5, "okay"), (1.6, 2.2, "let's"), (2.3, 2.9, "start")])]
        if len(participants) > 1:
            turns.append(("B", participants[1][0].format(mi), 5.0, 7.0, [(5.2, 6.0, "yeah")]))
        for agent, name, start, end, words in turns:
            (trans / "Segments" / f"{meet}.{agent}.segs.xml").write_text(
                '<?xml version="1.0"?>\n<segments>\n'
                f'  <segment participant="{name}" starttime="{start}" endtime="{end}"/>\n'
                "</segments>")
            (trans / "Words" / f"{meet}.{agent}.words.xml").write_text(
                '<?xml version="1.0"?>\n<words>\n' + "\n".join(
                    f'  <w starttime="{s}" endtime="{e}">{w}</w>' for s, e, w in words)
                + "\n</words>")
    preambles.append("</Meetings>")
    (trans / "preambles.mrt").write_text("\n".join(preambles))


def icsi_tree(root, layout="ihm", seconds=10.0):
    """``ihm``: tests/test_recipes.py:645 (chan0/chan1 per meeting, WAV data
    behind ``.sph`` names); ``sdm``: tests/test_recipes.py:704 (chan6 only);
    ``sphere``: every kind of channel as real SPHERE files (the headsets
    chan0/chan1, the distant chanE/F/6/7) and the headset mix as WAV."""
    audio, trans = root / "speech", root / "transcripts"
    if layout == "ihm":
        for mi, meet in enumerate(ICSI_MEETINGS):
            for ch in ("0", "1"):
                _wav(audio / meet / f"chan{ch}.sph", seconds=seconds, seed=100 + 2 * mi + int(ch))
        _icsi_transcripts(trans, ["chan0", "chan1"], [("me0{}", "chan0"), ("fe1{}", "chan1")])
    elif layout == "sdm":
        for mi, meet in enumerate(ICSI_MEETINGS):
            _wav(audio / meet / "chan6.sph", seconds=8.0, seed=5 + mi)
        _icsi_transcripts(trans, ["chan6"], [("me0{}", "chan6")])
    else:
        channels = ["chan0", "chan1", "chanE", "chanF", "chan6", "chan7"]
        for mi, meet in enumerate(ICSI_MEETINGS):
            for k, ch in enumerate(channels):
                _sph(audio / meet / f"{ch}.sph", seconds=seconds, seed=200 + 10 * mi + k)
            _wav(audio / meet / "Mix-Headset.wav", seconds=seconds, seed=300 + mi)
        _icsi_transcripts(trans, channels, [("me0{}", "chan0"), ("fe1{}", "chan1")])
    return audio, trans


def notsofar1_tree(root, layout="jax", seconds=10.0, mc_channels=2):
    """``jax``: tests/test_recipes_tranche3.py:852 (one meeting: sc, a
    2-channel mc device, one close-talk file, metadata); ``wide``: two
    meetings with a 7-channel mc device, two close-talk files and, for the
    second, no metadata file."""
    meetings = ["MTG001"] if layout == "jax" else ["MTG_30830", "MTG_30831"]
    if layout != "jax":
        mc_channels = 7
    for m, meet in enumerate(meetings):
        mtg = root / "benchmark-datasets" / "dev_set" / "v1" / "MTG" / meet
        seed = 67 + 10 * m
        _wav(mtg / "sc_dev1" / "ch0.wav", seconds=seconds, seed=seed)
        for ch in range(mc_channels):
            _wav(mtg / "mc_dev2" / f"ch{ch}.wav", seconds=seconds, seed=seed + 1 + ch)
        speakers = ["Alice"] if layout == "jax" else ["Alice", "Bob"]
        for k, spk in enumerate(speakers):
            _wav(mtg / "close_talk" / f"CT_{k + 1}.wav", seconds=seconds, seed=seed + 9 - k)
        transcript = [
            {"speaker_id": "Alice", "start_time": 1.0, "end_time": 2.5, "text": "hello meeting",
             "word_timing": [["hello", 1.0, 1.5], ["<eh>", 1.5, 1.6], ["meeting", 1.6, 2.5]]}]
        if layout != "jax":
            transcript.append(
                {"speaker_id": "Bob", "start_time": 2.25, "end_time": 4.75, "text": "good morning",
                 "word_timing": [["good", 2.25, 3.0], ["morning", 3.1, 4.75]]})
        (mtg / "gt_transcription.json").write_text(json.dumps(transcript))
        if m == 0:
            (mtg / "gt_meeting_metadata.json").write_text(json.dumps(
                {"ParticipantAliasToCtDevice": {s: f"CT_{k + 1}" for k, s in enumerate(speakers)}}))
    return root


LIBRICSS_SESSIONS = {
    "0L": "overlap_ratio_0.0_sil0.1_0.5_session0_actual0.0",
    "OV10": "overlap_ratio_10.0_sil0.1_1.0_session0_actual10.1"}


def libricss_tree(root, layout="wide", seconds=6.0):
    """``jax``: tests/test_recipes_tranche2.py:564 (one 0L session, a
    1-channel raw recording); ``wide``: 0L and OV10 sessions with the
    7-channel raw recording, the clean mix, the 8-channel per-speaker file,
    two speakers of the speaker-to-channel table and ``all_res.json``."""
    corpus = root / "for_release"
    for ov in jlibricss.OVERLAP_RATIOS:
        (corpus / ov).mkdir(parents=True)
    if layout == "jax":
        session = corpus / "0L" / LIBRICSS_SESSIONS["0L"]
        _wav(session / "record" / "raw_recording.wav", seconds=3.0, seed=94)
        (session / "transcription").mkdir(parents=True)
        (session / "transcription" / "meeting_info.txt").write_text(
            "start\tend\tspeaker\tutt_id\ttext\n0.5\t2.0\t103\t103-1240-0000\tCHAPTER ONE\n")
        return root
    windows = {}
    for k, (ov, name) in enumerate(LIBRICSS_SESSIONS.items()):
        session = corpus / ov / name
        _wav(session / "record" / "raw_recording.wav", seconds=seconds, seed=95 + k, channels=7)
        _wav(session / "clean" / "mix.wav", seconds=seconds, seed=97 + k)
        _wav(session / "clean" / "each_spk.wav", seconds=seconds, seed=99 + k, channels=8)
        (session / "transcription").mkdir(parents=True)
        spk_a, spk_b = sorted(jlibricss.SPK_TO_CHANNEL_MAP[name])[:2]
        (session / "transcription" / "meeting_info.txt").write_text(
            "start\tend\tspeaker\tutt_id\ttext\n"
            f"0.5\t2.5\t{spk_a}\t{spk_a}-1-0000\tCHAPTER ONE\n"
            f"2.0\t4.25\t{spk_b}\t{spk_b}-2-0001\tTHE END OF IT\n")
        windows[name] = [[0.0, 3.0], [3.0, seconds]]
    (corpus / "all_res.json").write_text(json.dumps(windows))
    return root


CHIME6_DEV = ("S02", "S09")


def chime6_tree(root, seconds=10.0):
    """tests/test_recipes_tranche17.py::_build_corpus: S02 with two arrays'
    channels (U01.CH1, U01.CH2, U06.CH1) and two binaural headsets, S09 with
    one array channel and one headset, and their transcripts."""
    (root / "audio" / "dev").mkdir(parents=True)
    (root / "transcriptions" / "dev").mkdir(parents=True)
    rng = np.random.RandomState(0)
    n = int(seconds * SR)
    for name in ("S02_U01.CH1", "S02_U01.CH2", "S02_U06.CH1"):
        write_wav(str(root / "audio" / "dev" / f"{name}.wav"),
                  (0.05 * rng.randn(n)).astype(np.float32), SR)
    for spk in ("P05", "P06"):
        write_wav(str(root / "audio" / "dev" / f"S02_{spk}.wav"),
                  (0.05 * rng.randn(2, n)).astype(np.float32), SR)
    for name in ("S09_U01.CH1", "S09_P52"):
        data = (0.05 * rng.randn(*(2, n) if "P" in name else (n,))).astype(np.float32)
        write_wav(str(root / "audio" / "dev" / f"{name}.wav"), data, SR)
    (root / "transcriptions" / "dev" / "S09.json").write_text(json.dumps(
        [{"start_time": "0:00:00.50", "end_time": "0:00:01.00", "words": "ok", "speaker": "P52"}]))
    (root / "transcriptions" / "dev" / "S02.json").write_text(json.dumps([
        {"start_time": "0:00:01.50", "end_time": "0:00:03.00", "words": "Hello, there! [inaudible 0:01:02]",
         "speaker": "P05", "location": "kitchen", "ref": "U06"},
        {"start_time": "0:00:05.00", "end_time": "0:00:05.00", "words": "dropped", "speaker": "P06"},
        {"start_time": "0:00:04.00", "end_time": "0:00:06.50", "words": "mm- [redacted] yes",
         "speaker": "P06", "location": "dining", "ref": "U01"}]))
    return root


DIPCO_ARRAYS = 5  # 5 arrays x 7 channels: the 35 channels of an mdm supervision


def dipco_tree(root, arrays=False, seconds=2.0):
    """tests/test_recipes_tranche2.py:188 (one close-talk file per session);
    with ``arrays``, also a second speaker and the 5 x 7 array channels."""
    seed = 30
    for part, sessions in jdipco.SESSIONS.items():
        for session in sessions:
            seed += 1
            _wav(root / "audio" / part / f"{session}_P01.wav", seconds=seconds, seed=seed)
            segs = [{"speaker_id": "P01", "start_time": {"close-talk": "00:00:00.25"},
                     "end_time": {"close-talk": "00:00:01.25"}, "words": "pass the salt",
                     "gender": "female", "nativeness": "native", "mother_tongue": "English"}]
            if arrays:
                _wav(root / "audio" / part / f"{session}_P02.wav", seconds=seconds, seed=seed + 500)
                for u in range(1, DIPCO_ARRAYS + 1):
                    for ch in range(1, 8):
                        _wav(root / "audio" / part / f"{session}_U{u:02d}.CH{ch}.wav",
                             seconds=seconds, seed=seed + 10 * u + ch)
                segs.append({"speaker_id": "P02", "start_time": {"close-talk": "00:00:01.10"},
                             "end_time": {"close-talk": "00:00:01.95"},
                             "words": "Thanks, [noise] sure.", "gender": "male",
                             "nativeness": "non-native", "mother_tongue": "German"})
            tdir = root / "transcriptions" / part
            tdir.mkdir(parents=True, exist_ok=True)
            (tdir / f"{session}.json").write_text(json.dumps(segs))
    return root


# -- comparisons ----------------------------------------------------------------------------


def _dicts(manifests, placeholders=()):
    """Nested manifest dicts as plain data, manifest items as ``to_dict()``,
    each of ``placeholders`` (paths) replaced by ``<out>``."""
    def plain(m):
        if isinstance(m, dict):
            return {k: plain(v) for k, v in m.items()}
        return [item.to_dict() for item in m]

    text = json.dumps(plain(manifests))
    for p in placeholders:
        text = text.replace(str(p), "<out>")
    return json.loads(text)


def _decompressed(directory, placeholder=None) -> dict:
    out = {}
    for p in sorted(directory.glob("*.jsonl.gz")):
        text = gzip.decompress(p.read_bytes()).decode()
        out[p.name] = text.replace(str(placeholder), "<out>") if placeholder else text
    return out


def _both(tmp_path, prepare_port, prepare_jax, *args, placeholders=False, **kwargs):
    """Run each package's recipe into its own output directory; check the
    manifests and the written files equal. Returns the port's manifests and
    written files."""
    ours = prepare_port(*args, output_dir=tmp_path / "ours", **kwargs)
    theirs = prepare_jax(*args, output_dir=tmp_path / "jax", **kwargs)
    pl_ours = (tmp_path / "ours",) if placeholders else ()
    pl_jax = (tmp_path / "jax",) if placeholders else ()
    assert _dicts(ours, pl_ours) == _dicts(theirs, pl_jax)
    written = _decompressed(tmp_path / "ours", pl_ours[0] if pl_ours else None)
    assert written == _decompressed(tmp_path / "jax", pl_jax[0] if pl_jax else None)
    return ours, written


def _sups(manifests, part):
    return list(manifests[part]["supervisions"])


# -- the TextGrid reader --------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["F_SPK0093", "1", "R0001_M0001_F_SPK0093"])
def test_parse_textgrid_equals_jax(tier):
    ours = ptextgrid.parse_textgrid(TEXTGRID.format(tier=tier))
    theirs = jtextgrid.parse_textgrid(TEXTGRID.format(tier=tier))
    assert [(t.name, [vars(i) for i in t.intervals]) for t in ours] == [
        (t.name, [vars(i) for i in t.intervals]) for t in theirs]
    assert ours[0].name == tier and ours[0].intervals[0].mark == "你好"
    assert ours[0].intervals[0].minTime == 0.25 and len(ours[0].intervals) == 2


def test_read_textgrid_equals_jax(tmp_path):
    text = textgrid({"1": [(0.3, 1.7, "今天"), (1.7, 2.0, "")], "2": [(1.5, 2.9, "嗯")]}, 3.0)
    (tmp_path / "a.TextGrid").write_text(text, encoding="utf-16")  # Praat's default
    (tmp_path / "b.TextGrid").write_text(text.replace('"IntervalTier"', '"TextTier"'))
    ours = ptextgrid.read_textgrid(tmp_path / "a.TextGrid")
    theirs = jtextgrid.read_textgrid(tmp_path / "a.TextGrid")
    assert [vars(i) for t in ours for i in t.intervals] == [
        vars(i) for t in theirs for i in t.intervals]
    assert [t.name for t in ours] == ["1", "2"]
    for read in (ptextgrid.read_textgrid, jtextgrid.read_textgrid):
        with pytest.raises(ValueError, match="No IntervalTier"):
            read(tmp_path / "b.TextGrid")


# -- the recipes against JAX ------------------------------------------------------------------


@pytest.mark.parametrize("layout,normalize_text", [
    ("jax", False), ("array", False), ("array", True)])
def test_prepare_aishell4_equals_jax(tmp_path, layout, normalize_text):
    root = aishell4_tree(tmp_path / "aishell4", layout)
    ours, written = _both(tmp_path, paishell4.prepare_aishell4, jaishell4.prepare_aishell4, root,
                          normalize_text=normalize_text)
    if layout == "jax":
        (sup,) = _sups(ours, "test")
        assert sup.speaker == "SPK0001" and sup.text == "你好"
        return
    assert set(ours) == {"train_L", "test"} and len(written) == 4
    rec = ours["train_L"]["recordings"]["L_R003S01C02"]
    assert rec.num_channels == 8 and len(ours["train_L"]["recordings"]) == 1
    sups = _sups(ours, "train_L")
    assert len(sups) == 4 and all(s.channel == list(range(8)) for s in sups)
    assert {s.speaker for s in _sups(ours, "test")} == {"SPK0003", "SPK0004"}
    if normalize_text:
        assert [s.text for s in sups][:2] == ["今天开会", "BT好的"]
    assert paishell4.text_normalize("ａ<sil>ｂ，c") == jaishell4.text_normalize("ａ<sil>ｂ，c")


@pytest.mark.parametrize("mic", ["far", "mdm", "sdm", "near", "ihm"])
@pytest.mark.parametrize("normalize_text", ["none", "m2met"])
def test_prepare_ali_meeting_equals_jax(tmp_path, mic, normalize_text):
    root = ali_meeting_tree(tmp_path / "AliMeeting")
    ours, written = _both(tmp_path, pali.prepare_ali_meeting, jali.prepare_ali_meeting, root,
                          mic=mic, normalize_text=normalize_text)
    assert set(ours) == {"train", "eval"} and len(written) == 4
    (sup,) = _sups(ours, "train")
    assert sup.speaker == "0093" and sup.gender == "F" and sup.start == 0.25
    assert sup.channel == (list(range(8)) if mic in ("far", "mdm") else 0)
    eval_sups = _sups(ours, "eval")
    assert len(eval_sups) == 2  # the empty interval is dropped
    if normalize_text == "m2met" and mic in ("far", "mdm", "sdm"):
        assert eval_sups[0].text == "好的K歌"


def test_ali_meeting_save_mono_as_jax(tmp_path):
    """With ``save_mono`` (sdm) both packages run ``sox``: where it is
    missing, both raise the same error; where it is found, both write the
    same mono files and manifests."""
    root = ali_meeting_tree(tmp_path / "AliMeeting")
    if shutil.which("sox") is None:
        for prepare in (pali.prepare_ali_meeting, jali.prepare_ali_meeting):
            with pytest.raises(subprocess.CalledProcessError):
                prepare(root, output_dir=tmp_path / "out", mic="sdm", save_mono=True)
    else:
        ours, _ = _both(tmp_path, pali.prepare_ali_meeting, jali.prepare_ali_meeting, root,
                        mic="sdm", save_mono=True, placeholders=True)
        assert ours["train"]["recordings"]["R0001_M0001"].num_channels == 1
    for prepare in (pali.prepare_ali_meeting, jali.prepare_ali_meeting):
        with pytest.raises(ValueError, match="output_dir"):
            prepare(root, mic="sdm", save_mono=True)
    assert pali._far_tier_identity("R8001_M8004_F_SPK8014") == ("F", "8014")
    assert pali.normalize_text_alimeeting("<sil>ａ，b", "m2met") == (
        jali.normalize_text_alimeeting("<sil>ａ，b", "m2met"))


@pytest.mark.parametrize("layout,mic,save_to_wav", [
    ("ihm", "ihm", False), ("sdm", "sdm", False), ("sdm", "sdm", True),
    ("sphere", "ihm", False), ("sphere", "mdm", False), ("sphere", "sdm", False),
    ("sphere", "ihm-mix", False), ("sphere", "mdm", True), ("sphere", "ihm", True)])
def test_prepare_icsi_equals_jax(tmp_path, layout, mic, save_to_wav):
    audio, trans = icsi_tree(tmp_path / "icsi", layout)
    ours, written = _both(tmp_path, picsi.prepare_icsi, jicsi.prepare_icsi, audio,
                          transcripts_dir=trans, mic=mic, save_to_wav=save_to_wav,
                          placeholders=save_to_wav)
    assert set(ours) == {"train", "dev", "test"} and len(written) == 6
    rec = ours["train"]["recordings"]["Bdb001"]
    # The sphere layout's ihm recording holds chan0, chan1, chan6 and chan7:
    # the digits of the ihm channel pattern.
    assert rec.num_channels == {"ihm": 2 if layout == "ihm" else 4, "mdm": 4}.get(mic, 1)
    sups = sorted(_sups(ours, "train"), key=lambda s: s.start)
    assert sups[0].text == "OKAY LET'S START"
    assert [w.symbol for w in sups[0].alignment["word"]] == ["OKAY", "LET'S", "START"]
    if save_to_wav:
        assert all(s.source.endswith(".wav") for s in rec.sources)
        for wav in sorted((tmp_path / "ours" / "wavs").rglob("*.wav")):
            theirs = tmp_path / "jax" / wav.relative_to(tmp_path / "ours")
            assert wav.read_bytes() == theirs.read_bytes()
        assert rec.load_audio().shape == (rec.num_channels, rec.num_samples)


def test_icsi_helpers_equal_jax(tmp_path):
    audio, trans = icsi_tree(tmp_path / "icsi", "sphere")
    ours, ours_map = picsi.parse_icsi_annotations(trans)
    theirs, theirs_map = jicsi.parse_icsi_annotations(trans)
    assert ours_map == theirs_map and list(ours) == list(theirs)
    for key in ours:  # named tuples of named tuples: compared as tuples
        assert [tuple(a) for a in ours[key]] == [tuple(a) for a in theirs[key]]
    paths = sorted(audio.rglob("chan[EF67].sph"))
    assert _dicts({"r": picsi.prepare_audio_grouped(paths)}) == _dicts(
        {"r": jicsi.prepare_audio_grouped(paths)})
    for prepare in (picsi.prepare_icsi, jicsi.prepare_icsi):
        with pytest.raises(AssertionError):
            prepare(audio, transcripts_dir=trans, mic="sdm", save_to_wav=True)


@pytest.mark.parametrize("layout", ["jax", "wide"])
def test_prepare_notsofar1_equals_jax(tmp_path, layout):
    root = notsofar1_tree(tmp_path / "notsofar", layout)
    ours, written = _both(tmp_path, pnotsofar1.prepare_notsofar1, jnotsofar1.prepare_notsofar1,
                          root)
    dev = ours["dev_set"]["v1"]
    assert set(dev) == {"single_channel", "multi_channel", "close_talk"} and len(written) == 6
    assert [a.symbol for a in list(dev["single_channel"]["supervisions"])[0].alignment["word"]] == [
        "hello", "meeting"]
    assert list(dev["multi_channel"]["recordings"])[0].num_channels == (
        2 if layout == "jax" else 7)
    if layout == "wide":
        ihm = {s.recording_id: s.speaker for s in dev["close_talk"]["supervisions"]}
        assert ihm == {"MTG_30830_close_talk_CT_1": "Alice", "MTG_30830_close_talk_CT_2": "Bob"}
    for prepare in (pnotsofar1.prepare_notsofar1, jnotsofar1.prepare_notsofar1):
        with pytest.raises(ValueError, match="output_dir"):
            prepare(root)


@pytest.mark.parametrize("layout,mic_type", [
    ("jax", "sdm"), ("wide", "mdm"), ("wide", "sdm"), ("wide", "ihm-mix"), ("wide", "ihm")])
def test_prepare_libricss_equals_jax(tmp_path, layout, mic_type):
    root = libricss_tree(tmp_path / "libricss", layout)
    ours, written = _both(tmp_path, plibricss.prepare_libricss, jlibricss.prepare_libricss, root,
                          type=mic_type)
    assert len(written) == 2
    sups = list(ours["supervisions"])
    if layout == "jax":
        (sup,) = sups
        assert sup.recording_id == "0L_session0" and sup.text == "CHAPTER ONE"
        return
    assert {r.id for r in ours["recordings"]} == {"0L_session0", "OV10_session0"}
    want = {"mdm": list(range(7)), "sdm": 0, "ihm-mix": 0}.get(mic_type)
    for s in sups:
        session = LIBRICSS_SESSIONS[s.recording_id.split("_")[0]]
        assert s.channel == (want if want is not None
                             else jlibricss.SPK_TO_CHANNEL_MAP[session][s.speaker])


@pytest.mark.parametrize("mic_type", ["mdm", "sdm"])
def test_libricss_segments_where_jax_finds_none(tmp_path, mic_type):
    """``segmented_cuts=True``: the port cuts each session into its
    ``all_res.json`` windows. The JAX package looks the windows up by cut id
    (``<session>-0`` from ``from_manifests``) rather than by session, finds
    none and returns no segments; its recordings and supervisions are the
    port's."""
    root = libricss_tree(tmp_path / "libricss", "wide")
    # The segments are truncated with preserve_id=False: uuid4 ids, seeded.
    fix_random_seed(0)
    ours = plibricss.prepare_libricss(root, output_dir=tmp_path / "ours", type=mic_type,
                                      segmented_cuts=True)
    jfix(0)
    theirs = jlibricss.prepare_libricss(root, output_dir=tmp_path / "jax", type=mic_type,
                                        segmented_cuts=True)
    assert _dicts({k: ours[k] for k in ("recordings", "supervisions")}) == _dicts(
        {k: theirs[k] for k in ("recordings", "supervisions")})
    assert len(theirs["segments"]) == 0
    segments = sorted(ours["segments"], key=lambda c: (c.recording_id, c.start))
    assert [(c.recording_id, c.start, c.duration) for c in segments] == [
        (rec, start, 3.0) for rec in ("0L_session0", "OV10_session0") for start in (0.0, 3.0)]
    # Each window keeps the supervisions it overlaps.
    assert [len(c.supervisions) for c in segments] == [2, 1, 2, 1]
    assert all(np.isfinite(c.load_audio()).all() for c in segments)
    written = _decompressed(tmp_path / "ours")
    assert len(written) == 3 and written["libricss-%s_segments_all.jsonl.gz" % mic_type].count(
        '"id"') >= 4


@pytest.mark.parametrize("kwargs", [
    dict(mic="mdm"), dict(mic="mdm", use_reference_array=True), dict(mic="ihm"),
    dict(mic="mdm", normalize_text="upper"), dict(mic="ihm", normalize_text="none"),
    dict(mic="mdm", use_chime7_split=True)],
    ids=["mdm", "mdm-ref", "ihm", "mdm-upper", "ihm-none", "chime7"])
def test_prepare_chime6_equals_jax(tmp_path, kwargs):
    root = chime6_tree(tmp_path / "CHiME6")
    ours, written = _both(tmp_path, pchime6.prepare_chime6, jchime6.prepare_chime6, root,
                          dataset_parts=["dev"], **kwargs)
    assert set(ours) == {"dev"} and len(written) == 2
    rec = ours["dev"]["recordings"]["S02"]
    assert rec.num_channels == (4 if kwargs["mic"] == "ihm" else 3)
    sups = {s.id: s for s in _sups(ours, "dev")}
    assert "S02-1" not in sups  # zero duration
    if kwargs.get("use_reference_array"):
        assert sups["S02-0"].channel == [2] and sups["S02-2"].channel == [0, 1]
    elif kwargs["mic"] == "ihm":
        assert sups["S02-0"].channel == [0, 1] and sups["S02-2"].channel == [2, 3]
    if kwargs.get("normalize_text", "kaldi") == "kaldi":
        assert sups["S02-0"].text == "hello there [inaudible]" and sups["S02-2"].text == ""


def test_chime6_refusals_and_helpers(tmp_path):
    root = chime6_tree(tmp_path / "CHiME6")
    # Where the JAX package downloads the synchroniser's edits or the checksum
    # list, the port raises and names the download.
    for flag, what in (("perform_array_sync", "audio edits"),
                       ("verify_md5_checksums", "checksum list")):
        with pytest.raises(NotImplementedError, match=f"Downloading the CHiME-6 {what}"):
            pchime6.prepare_chime6(root, output_dir=tmp_path / "o", dataset_parts="dev",
                                   **{flag: True})
    for prepare in (pchime6.prepare_chime6, jchime6.prepare_chime6):
        with pytest.raises(FileNotFoundError):  # the train sessions are missing
            prepare(root, dataset_parts="all")
        with pytest.raises(AssertionError):
            prepare(root, dataset_parts="dev", mic="sdm")
    for stamp in ("0:00:01.50", "01:02:03.456", "00:59:59.9995"):
        seconds = pchime6.hms_to_seconds(stamp)
        assert seconds == jchime6.hms_to_seconds(stamp)
        assert pchime6.seconds_to_hms(seconds) == jchime6.seconds_to_hms(seconds)
    for mode in ("none", "upper", "kaldi"):
        text = "Mm- yes. [inaudible 0:01] - so"
        assert pchime6.normalize_text_chime6(text, mode) == jchime6.normalize_text_chime6(text, mode)
    assert pchime6.SESSIONS == jchime6.SESSIONS and pchime6.SESSIONS_CHIME7 == jchime6.SESSIONS_CHIME7


@pytest.mark.parametrize("arrays,mic,kwargs", [
    (False, "ihm", {}), (True, "ihm", dict(normalize_text="upper")),
    (True, "mdm", {}), (True, "mdm", dict(use_chime7_offset=True, normalize_text="none"))])
def test_prepare_dipco_equals_jax(tmp_path, arrays, mic, kwargs):
    root = dipco_tree(tmp_path / "DiPCo", arrays=arrays)
    ours, written = _both(tmp_path, pdipco.prepare_dipco, jdipco.prepare_dipco, root, mic=mic,
                          **kwargs)
    assert set(ours) == {"dev", "eval"} and len(written) == 4
    assert len(ours["dev"]["recordings"]) == 5
    sup = _sups(ours, "dev")[0]
    assert sup.start == 0.25 and abs(sup.duration - 1.0) < 1e-6
    assert sup.custom["nativeness"] == "native"
    if mic == "mdm":
        assert list(ours["dev"]["recordings"])[0].num_channels == 35
        assert sup.channel == list(range(35))
    if kwargs.get("use_chime7_offset"):
        assert {r.id for r in ours["dev"]["recordings"]} == {"S26", "S28", "S29", "S33", "S34"}
    assert pdipco.get_session_id("S05", True) == jdipco.get_session_id("S05", True) == "S29"


# -- the slice: AISHELL-4 into OnTheFlyFeatures ----------------------------------------------


def _aishell4_chain(pkg, root, workdir):
    """prepare_aishell4 → from_manifests → trim_to_supervisions with every
    channel → to_mono → the sampler's batches through the dataset."""
    if pkg == "port":
        m = SimpleNamespace(prepare=paishell4.prepare_aishell4, CutSet=CutSet,
                            Sampler=SimpleCutSampler, Dataset=K2SpeechRecognitionDataset,
                            strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    else:
        # The JAX extractors' device route, in XLA on the CPU.
        m = SimpleNamespace(prepare=jaishell4.prepare_aishell4, CutSet=J.CutSet, Sampler=JSimple,
                            Dataset=JDataset, strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))))
    manifests = m.prepare(root, output_dir=workdir)
    sessions = m.CutSet.from_manifests(**manifests["train_L"])
    trimmed = sessions.trim_to_supervisions(keep_overlapping=False, keep_all_channels=True)
    monos = m.CutSet.from_cuts(mono for c in trimmed for mono in c.to_mono())
    dataset = m.Dataset(return_cuts=True, input_strategy=m.strategy)
    batches = [dataset[b] for b in m.Sampler(monos, max_duration=12.0)]
    return sessions, monos, batches


def test_aishell4_slice_equals_jax(tmp_path):
    root = aishell4_tree(tmp_path / "aishell4", "array", channels=8)
    sessions, monos, ours = _aishell4_chain("port", root, tmp_path / "ours")
    jsessions, jmonos, theirs = _aishell4_chain("jax", root, tmp_path / "jax")
    assert [type(c) for c in sessions] == [MultiCut]
    assert _dicts({"s": sessions, "m": monos}) == _dicts({"s": jsessions, "m": jmonos})
    assert len(monos) == 4 * 8 and {type(c) for c in monos} == {MonoCut}
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert a["inputs"].shape == b["inputs"].shape and np.isfinite(a["inputs"]).all()
        np.testing.assert_allclose(a["inputs"], b["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        for key in ("sequence_idx", "start_frame", "num_frames"):
            np.testing.assert_array_equal(a["supervisions"][key], b["supervisions"][key])
        assert a["supervisions"]["text"] == b["supervisions"]["text"]
