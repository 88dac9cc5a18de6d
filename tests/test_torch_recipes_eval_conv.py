"""
The port's last five recipes (lhotse_tpu_torch.recipes ``wenet_speech``,
``gigaspeech``, ``uwb_atcc``, ``this_american_life`` and ``sbcsae``)
against the JAX package's, on the fixture layouts of
tests/test_recipes.py:175,577, tests/test_recipes_tranche3.py:367,381,958,970,
tests/test_recipes_tranche4.py:149 and tests/test_recipes_tranche18.py:60-157
(made from the same numpy seeds), and on wider layouts of the same formats:
WenetSpeech with nested S ⊂ M ⊂ L subsets, the three evaluation sets and a
segment past its recording's end, at one and two jobs; GigaSpeech through a
stub ``speechcolab`` SDK (installed for both packages) over two parts, a
stereo entry and a cached re-run; UWB-ATCC with a cut-off cp1250 transcript,
mixed speaker roles, a missing recording and its ``*_sym`` options; This
American Life over three parts with a missing episode, under nltk, under a
Treebank tokenizer and under the regex; SBCSAE with the speaker tables of
Parts 1-4, mono, stereo and ``bad_stereo`` recordings, unmapped speakers and
code-switched lines. Also the two SBCSAE faults the port keeps out (ROADMAP
C2: unmapped-speaker ids that depend on earlier calls, and ultra-short
segments stretched to the recording's end), the behaviour it keeps, the
network paths that raise ``NotImplementedError`` naming their URL, the
downloads left out, the ``prepare`` commands through both CLIs, and the
slice at a small size: WenetSpeech's L segments through each package's
``OnDeviceAugmenter`` (within ``AUG_TOL`` of the JAX augmenter with its
fbank layer's kernel route in float64).
"""
import ast
import inspect
import json
import subprocess
import sys
import types
from importlib.machinery import ModuleSpec
from pathlib import Path

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.recipes import gigaspeech as jgigaspeech
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.recipes import sbcsae as jsbcsae
from lhotse_tpu.recipes import this_american_life as jtal
from lhotse_tpu.recipes import uwb_atcc as juwb
from lhotse_tpu.recipes import wenet_speech as jwenet
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu.utils.core import _module_available as j_module_available
from lhotse_tpu_torch.audio import syscodecs
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.recipes import gigaspeech as pgigaspeech
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.recipes import sbcsae as psbcsae
from lhotse_tpu_torch.recipes import this_american_life as ptal
from lhotse_tpu_torch.recipes import uwb_atcc as puwb
from lhotse_tpu_torch.recipes import wenet_speech as pwenet
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import _module_available as p_module_available
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_recipes_asr import _dicts
from test_torch_recipes_asr_corpora import _sig, _wav, _words
from test_torch_recipes_kws_eval import _mp3_available, _txt
from test_torch_recipes_noise import AUG_TOL, musan_tree, noise_pool, rir_noise_tree, seeded_rir
from test_torch_recipes_overlap import _files
from test_torch_recipes_zh import _JaxKernelRoute64, _bucketed

SR = 16000
ROOT = Path(__file__).resolve().parent.parent
MANDARIN = ("大家", "好", "今天", "天气", "很好", "我们", "一起", "学习", "再见", "新闻")
ENGLISH = ("well", "i", "don't", "know", "it's", "ira's", "show", "and", "the", "radio",
           "program", "today", "we", "have", "stories")


# -- the layouts -----------------------------------------------------------------------------

WENET_TRAIN = 4  # train recordings of the wide layout, three segments each
WENET_EVAL = (("DEV", "dev"), ("TEST_NET", "test_net"), ("TEST_MEETING", "test_meeting"))


def wenet_speech_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes.py:577 (one 10 s recording, a segment
    in L, M and DEV and one in L); ``wide``: four 8-10 s train recordings of
    three 1-2.5 s segments each at the release's ``audio/<split>/...``
    paths (WAV data behind ``.opus`` names), every segment in L, the first
    two of each recording in M too and the first in S, and one recording
    each of DEV, TEST_NET and TEST_MEETING; one L segment ends past its
    recording, and texts carry the spaces the recipe strips."""
    root = root / "WenetSpeech"
    if layout == "jaxtest":
        _wav(root / "audio" / "X0001.wav", seconds=10.0, seed=95)
        meta = {"audios": [{"aid": "X0001", "path": "audio/X0001.wav", "duration": 10.0,
                            "segments": [
                                {"sid": "X0001_S0001", "begin_time": 0.5, "end_time": 3.0,
                                 "text": " 大家好 ", "subsets": ["L", "M", "DEV"]},
                                {"sid": "X0001_S0002", "begin_time": 4.0, "end_time": 6.5,
                                 "text": "再见", "subsets": ["L"]}]}]}
        _txt(root / "WenetSpeech.json", json.dumps(meta))
        return (root,), {"dataset_parts": ["L", "DEV"]}
    rng, audios = np.random.RandomState(seed), []
    specs = [("train", f"Y{1000 + k:010d}", ("L",)) for k in range(WENET_TRAIN)]
    specs += [(split, f"{part[0]}{2000 + k:010d}", (part,))
              for k, (part, split) in enumerate(WENET_EVAL)]
    for k, (split, aid, parts) in enumerate(specs):
        seconds = round(float(rng.uniform(8.0, 10.0)), 2)
        path = f"audio/{split}/youtube/B{k:05d}/{aid}.opus"
        _wav(root / path, seconds, seed + k)
        t, segments = 0.25, []
        for j in range(3 if split == "train" else 2):
            length = round(float(rng.uniform(1.0, 2.5)), 2)
            end = round(t + length, 2)
            if split == "train" and k == 1 and j == 2:  # past the recording's end
                t, end = round(seconds - 1.5, 2), round(seconds + 0.37, 2)
            subsets = list(parts) + (["M"] if split == "train" and j < 2 else []) + (
                ["S"] if split == "train" and j == 0 else [])
            text = _words(rng, MANDARIN, sep="")
            segments.append({"sid": f"{aid}_S{j:05d}", "begin_time": t, "end_time": end,
                             "text": f" {text} " if j % 2 else text, "subsets": subsets,
                             "confidence": 1.0})
            t = round(end + float(rng.uniform(0.1, 0.6)), 2)
        audios.append({"aid": aid, "path": path, "duration": seconds, "title": aid,
                       "segments": segments})
    _txt(root / "WenetSpeech.json", json.dumps({"dataset": "WenetSpeech", "audios": audios},
                                               ensure_ascii=False))
    return (root,), {"dataset_parts": "all"}


def _gigaspeech_entries(root, layout, seed):
    """The SDK's audio entries by part, their audio written under ``root``."""
    if layout == "jaxtest":  # tests/test_recipes_tranche18.py:34
        entries = []
        for k, (aid, dur) in enumerate([("POD0000000001", 3.0), ("POD0000000002", 2.0)]):
            rel = f"audio/podcast/{aid}.wav"
            _wav(root / rel, dur, k)
            entries.append({"aid": aid, "path": rel, "sample_rate": SR, "channels": 1,
                            "duration": dur, "segments": [
                                {"sid": f"{aid}_S{j:07d}", "begin_time": 0.5 * j,
                                 "end_time": 0.5 * j + 0.4, "speaker": f"spk{j}",
                                 "text_tn": f"SEGMENT {j} OF {aid}"} for j in range(2)]})
        return {"DEV": entries}
    rng, parts = np.random.RandomState(seed), {}
    for part, names in (("DEV", ("POD1000000001", "YOU1000000002", "AUD1000000003")),
                        ("TEST", ("POD1000000011", "YOU1000000012"))):
        parts[part] = []
        for k, aid in enumerate(names):
            seconds, channels = round(float(rng.uniform(3.0, 5.0)), 2), 2 if k == 1 else 1
            rel = f"audio/{aid[:3].lower()}/P{k:04d}/{aid}.wav"
            _wav(root / rel, seconds, seed + k, channels=channels)
            t, segments = 0.13, []
            for j in range(3):
                end = round(t + float(rng.uniform(0.4, 1.0)), 3)
                segments.append({"sid": f"{aid}_S{j:07d}", "begin_time": t, "end_time": end,
                                 "speaker": "N/A" if j == 2 else f"{aid}_spk{j}",
                                 "text_tn": _words(rng, ENGLISH).upper() + " <COMMA> ",
                                 "subsets": ["{" + part + "}"]})
                t = round(end + float(rng.uniform(0.05, 0.3)), 3)
            parts[part].append({"aid": aid, "path": rel, "sample_rate": SR,
                                "channels": channels, "duration": seconds,
                                "segments": segments})
    return parts


def gigaspeech_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche18.py:34 (two podcast entries
    of DEV with two segments each); ``wide``: three DEV and two TEST entries
    of 3-5 s, one stereo, with three segments each (one speaker ``N/A``).
    The stub SDK reads the entries from ``entries.json`` in the corpus."""
    root = root / "gigaspeech"
    root.mkdir(parents=True, exist_ok=True)
    parts = _gigaspeech_entries(root, layout, seed)
    _txt(root / "entries.json", json.dumps(parts))
    return (root,), {"dataset_parts": list(parts)}


SDK_CALLS = []  # the parts the stub SDK served, in order


class _FakeGigaSpeech:
    """The ``speechcolab`` SDK's ``GigaSpeech``, serving ``entries.json``."""

    def __init__(self, corpus_dir):
        self.gigaspeech_dataset_dir = Path(corpus_dir)

    def audios(self, subset):
        SDK_CALLS.append(subset)
        parts = json.loads((self.gigaspeech_dataset_dir / "entries.json").read_text())
        return iter(parts.get(subset.strip("{}"), []))

    def download(self, password, subset, host=None):
        raise AssertionError("prepare must not download")


def _clear_module_caches():
    j_module_available.cache_clear()
    p_module_available.cache_clear()


@pytest.fixture
def speechcolab(monkeypatch):
    """A stub ``speechcolab`` SDK in ``sys.modules`` for both packages, as
    tests/test_recipes_tranche18.py:60 installs it."""
    modules = {}
    for name, package in (("speechcolab", True), ("speechcolab.datasets", True),
                          ("speechcolab.datasets.gigaspeech", False)):
        modules[name] = types.ModuleType(name)
        modules[name].__spec__ = ModuleSpec(name, loader=None, is_package=package)
        if package:
            modules[name].__path__ = []
    modules["speechcolab.datasets.gigaspeech"].GigaSpeech = _FakeGigaSpeech
    modules["speechcolab"].datasets = modules["speechcolab.datasets"]
    modules["speechcolab.datasets"].gigaspeech = modules["speechcolab.datasets.gigaspeech"]
    for name, module in modules.items():
        monkeypatch.setitem(sys.modules, name, module)
    _clear_module_caches()
    SDK_CALLS.clear()
    yield
    _clear_module_caches()


UWB_HEAD = '<?xml version="1.0" encoding="{encoding}"?>\n<Trans audio_filename="e2_{name}.wav">\n'
UWB_TEXTS = (
    "[ground] lufthansa 4 7 A climb FL 310 [ehm_] roger",
    "[air] climbing FL 310 lufthansa 4 7 alfa",
    "[ground_|] [noise_|]contact[|_noise] Praha Ruzyně 1 1 9 . 4 [|_ground]",
    "[air_|] 1 1 9 . 4 [NO_ENG_|]dobrý den[|_NO_ENG] [|_air]",
    "[ground] cleard ILS RWY 2 4 (RWY(runway)) HDO stand bye",
    "[air] [CZECH_|]nashledanou[|_CZECH] cli+ climbing +ing [UNINTELLIGIBLE_|]xx[|_UNINTELLIGIBLE]",
    "[ground] [noise]",  # nothing left after normalisation: dropped
    "no role here",  # no speaker role: dropped
    "[air] squak 7 0 0 0° affrim, 40 knots´s [speaker]",
)


def _uwb_trs(name, rng, encoding="windows-1250", truncated=False):
    """A Transcriber file of two sections: Syncs at times whose x100 is not
    whole (the ids truncate them), every text of ``UWB_TEXTS``."""
    out = [UWB_HEAD.format(encoding=encoding, name=name), "<Episode>"]
    t, texts = 0.29, list(UWB_TEXTS)
    for section, turns in (("report", 2), ("nontrans", 1)):
        out.append(f'<Section type="{section}" startTime="{t}" endTime="0">')
        for _ in range(turns):
            syncs = [texts.pop(0) for _ in range(3 if len(texts) > 3 else len(texts))]
            times = [round(t + 1.15 * i, 3) for i in range(len(syncs))]
            end = round(times[-1] + float(rng.uniform(0.6, 1.1)), 3)
            out.append(f'<Turn startTime="{times[0]}" endTime="{end}">')
            out += [f'<Sync time="{time}"/>\n{text}' for time, text in zip(times, syncs)]
            out.append("</Turn>")
            t = round(end + 0.05, 3)
        out.append("</Section>")
        if not texts:
            break
    out.append("</Episode></Trans>\n")
    text = "\n".join(out)
    if truncated:
        text = text[:text.rindex("</Turn>")]
    return text, t


def uwb_atcc_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche3.py:381 (one 10 s 8 kHz
    recording, a ground and an air segment); ``wide``: a cp1250 transcript
    with Czech letters over two sections, one of the release's cut-off
    transcripts (``ACCU-80UXVV``, its closing tags missing), and a
    transcript whose recording is missing, at 8 kHz."""
    if layout == "jaxtest":
        _wav(root / "TWR-test1.wav", seconds=10.0, sr=8000, seed=34)
        _txt(root / "TWR-test1.trs",
             '<?xml version="1.0" encoding="UTF-8"?>\n'
             '<Trans audio_filename="e2_TWR-test1.wav">\n'
             '<Episode><Section type="report" startTime="0" endTime="10">\n'
             '<Turn startTime="0" endTime="10">\n'
             '<Sync time="0.5"/> [ground] contact praha\n'
             '<Sync time="3.0"/> [air] roger contact\n'
             "</Turn></Section></Episode></Trans>\n")
        return (root,), {}
    rng = np.random.RandomState(seed)
    for k, (name, truncated) in enumerate((("TWR-Ab12Cd", False), ("ACCU-80UXVV", True),
                                           ("APP-Missing", False))):
        text, seconds = _uwb_trs(name, rng, truncated=truncated)
        (root / f"{name}.trs").parent.mkdir(parents=True, exist_ok=True)
        (root / f"{name}.trs").write_bytes(text.encode("cp1250"))
        if name != "APP-Missing":
            _wav(root / f"{name}.wav", seconds + 1.0, seed + k, sr=8000)
    return (root,), {}


TAL_UTTERANCES = ("Well, I don't know.", "It's Ira's show!", "and the radio program today",
                  "We have stories... about it.", "Hello world")


def _tal_utterance(rng, text, start, n_words=None, extra_index=False):
    tokens = ptal._FALLBACK_TOKEN.findall(text)
    duration = round(float(rng.uniform(1.5, 3.0)), 2)
    step = duration / (len(tokens) + 1)
    alignments = [[round(start + i * step, 3), round(start + (i + 1) * step, 3), i]
                  for i in range(len(tokens))]
    if extra_index:
        alignments.append([round(start + duration - step, 3), round(start + duration, 3),
                           len(tokens) + 3])  # past the tokens: dropped
    return {"utterance": text, "n_words": len(tokens) if n_words is None else n_words,
            "utterance_start": start, "utterance_end": round(start + duration, 2),
            "speaker": ("Ira Glass", "interviewer", "narrator")[len(text) % 3],
            "alignments": alignments}


def this_american_life_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche4.py:149 (one 10 s episode, WAV
    data behind its ``.mp3`` name, one aligned utterance in train);
    ``wide``: two train episodes, a train episode without its MP3, one
    valid (``dev``) and one test episode of 10 s (WAV data behind ``.mp3``
    names), with punctuation and contractions that the tokenizers split
    apart, a word count that disagrees with the text and an alignment past
    the last token; ``mp3``: the wide layout with real MP3 audio."""
    if layout == "jaxtest":
        _wav(root / "audio" / "ep-1.mp3", seconds=10.0, seed=11)
        transcript = {"ep-1": [{"utterance": "hello world", "n_words": 2,
                                "utterance_start": 1.0, "utterance_end": 3.0,
                                "speaker": "host", "alignments": [[1.0, 1.5, 0], [1.6, 2.4, 1]]}]}
        for split in ("train", "valid", "test"):
            _txt(root / f"{split}-transcripts-aligned.json",
                 json.dumps(transcript if split == "train" else {}))
        return (root,), {}
    rng, parts = np.random.RandomState(seed), {}
    episodes = (("train", "ep-100"), ("train", "ep-101"), ("train", "ep-999"),
                ("valid", "ep-200"), ("test", "ep-300"))
    for k, (split, ep) in enumerate(episodes):
        utts, t = [], 0.5
        for j in range(2 if split == "train" else 1):
            text = TAL_UTTERANCES[(k + j) % len(TAL_UTTERANCES)]
            utts.append(_tal_utterance(rng, text, t, n_words=7 if split == "test" else None,
                                       extra_index=split == "test"))
            t = utts[-1]["utterance_end"] + 0.5
        parts.setdefault(split, {})[ep] = utts
        if ep == "ep-999":
            continue
        path = root / "audio" / f"{ep}.mp3"
        if layout == "mp3":
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(syscodecs.mp3_encode(_sig(10.0, seed + k), SR))
        else:
            _wav(path, 10.0, seed + k)
    for split in ("train", "valid", "test"):
        _txt(root / f"{split}-transcripts-aligned.json", json.dumps(parts[split]))
    return (root,), {}


def _sbc_docs(corpus, parts):
    for part in ("Part_1", "Part_2", "Part_3", "Part_4"):
        segment, speaker = parts.get(part, ((), ()))
        _txt(corpus / "docs" / part / "segment.tbl", "".join(f"{line}\n" for line in segment))
        _txt(corpus / "docs" / part / "speaker.tbl", "".join(f"{line}\n" for line in speaker))


SBC_DOCS = {
    "Part_1": (("sbc001 speaker: 0001 LENORE", "sbc001 speaker: 0002 LYNNE",
                "sbc001 speaker: 0003 DORIS", "sbc004 speaker: 0010 KATHY",
                "sbc004 speaker: 0011 NATHAN"),
               ("0001,Lenore,F,x,Walnut Cre CA,CA", "0002,Lynne,F,x,San Leandr CA,CA",
                "0003,Doris,F,x,?,?", "0010,Kathy,F,x,South FL,FL",
                "0011,Nathan (extra-corpus),M,x,,",
                "0069,Skipped,F,x,,")),
    "Part_2": (("sbc020 speaker: 0050 JAMIE", "sbc020 speaker: 0051 HAROLD",
                "sbc021 speaker: 0052 RICKIE"),
               ("0050,Jamie,f,x,Boston/Santa Fe MA/NM,", "0051,Harold,m,x,,",
                "0052,Rickie/Rick,,x,,")),
    "Part_3": (("sbc035 speaker: FRANK", "sbc035 speaker: MELISSA"),
               ("0120,Frank,M,x,,", "0121,Melissa,F,x,,")),
    "Part_4": (("sbc047 speaker: 0166 DAN", "sbc047 speaker: 0167 ALINA"),
               ("0163,Dan,m,x,,", "0167,Alina,F,x,,")),
}
SBC_TRN = {
    # reco: (seconds, channels, lines)
    "SBC001": (20.0, 2, (
        "0.00 0.00\tLENORE:\t(H)",
        "1.00 3.50\tLENORE:\t... So you don't need to go borrow equipment,",
        "3.50 4.20\t\t.. from anybody.",
        "4.20 5.00\t>ENV:\t((DOOR))",
        "5.10\t6.40\tLYNNE:\t[Yeah] @@@ X .",
        "6.40\t7.90\t(H) I mean he's (Hx) there",
        "8.00 9.50 DORIS: Right, and then [2he said2],",
        "9.60 10.30\tKEN:\tOkay.",
        "10.50 11.20\tKEN:\tYou@ know, <X what X>.",
        "12.00 14.00\tLENORE:\tso $ something",
        "14.20 15.00\tLYNNE:\t(TSK) ((SNIFF))",
    )),
    "SBC004": (20.0, 1, (
        "0.50 2.00\tKATE:\tThe se\xf1orita said <L2 hola L2> there.",
        "2.10 3.40\tNATHAN:\t<L2 Buenos dias L2>",
        "3.50 4.60\tKATE:\t<L2 Como estas,",
        "4.60 5.70\t\tmuy bien L2> okay.",
        "5.80 7.00\tNATHAN:\tAnd then we left.",
    )),
    "SBC020": (20.0, 2, (
        "1.000\t2.500\tJAMIE:\t(COUGh) We went up there,",
        "2.600\t3.900\tAUD:\tYeah right.",
        "4.000\t5.200\tHAROLD:\t... Yes we did.",
        "5.300\t6.000\tAUD:\t@@ That's it.",
    )),
    "SBC021": (20.0, 2, (
        "1.00 2.00\tRICKIE:\tHere we go.",
        "2.10 3.00\tJOE:\tWhat?",
        "3.10 4.00\tJOE:\tI said what.",
        "4.10 5.00\tMANY:\tYeah!",
    )),
    "SBC035": (20.0, 1, (
        "0.50 1.70\tFRANK:\tGood morning.",
        "1.80 3.10\tMELISSA:\tMorning Frank.",
    )),
    "SBC047": (20.0, 1, (
        "0.40 1.90\tDAN:\tWell it's a long story.",
        "2.00 3.30\tALINA:\tTell me.",
    )),
}


def sbcsae_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche3.py:970 (one 30 s stereo
    recording, a speaker of Part 1, a carried-over speaker and an ``>ENV``
    line); ``wide``: the speaker tables of Parts 1-4 (a ``(extra-corpus)``
    name, a skipped speaker number, Part 3 paired row by row, Part 4's
    ``0163,Dan,m`` erratum), a stereo recording (SBC001), a mono one with
    the ``KATE`` erratum and Spanish code-switching (SBC004), two
    ``bad_stereo`` ones (SBC020 with its ``AUD`` errata, SBC021 whose
    unmapped speakers get an id per line) and two mono ones (SBC035 of Part
    3, SBC047 of Part 4), in the .trn files' several row layouts, with
    unmapped speakers; ``short``: the jaxtest layout with an unmapped
    speaker ``KEN`` speaking for 10 ms at 10.000 s."""
    corpus = root / "SBCSAE"
    if layout in ("jaxtest", "short"):
        _wav(corpus / "WAV" / "SBC001.wav", seconds=30.0, seed=73, channels=2)
        _txt(corpus / "TRN" / "SBC001.trn",
             "1.00 3.50\tLENORE:\t... So you don't need to go borrow equipment,\n"
             "3.50 4.20\t\t.. from anybody.\n"
             "4.20 5.00\t>ENV:\t((DOOR))\n"
             + ("10.000 10.010\tKEN:\tYes.\n" if layout == "short" else ""))
        _sbc_docs(corpus, {"Part_1": (("sbc001 speaker:\t0001 LENORE",),
                                      ("0001,Lenore,F,x,Walnut Cre CA,CA",))})
        return (corpus,), {"omit_realignments": True}
    for k, (reco, (seconds, channels, lines)) in enumerate(SBC_TRN.items()):
        _wav(corpus / "WAV" / f"{reco}.wav", seconds, seed + k, channels=channels)
        _txt(corpus / "TRN" / f"{reco}.trn", "\n".join(lines) + "\n", encoding="latin-1")
    _sbc_docs(corpus, SBC_DOCS)
    return (corpus,), {"omit_realignments": True}


# -- each recipe against JAX -----------------------------------------------------------------

RECIPES = ("wenet_speech", "gigaspeech", "uwb_atcc", "this_american_life", "sbcsae")
MODULES = {"wenet_speech": (pwenet, jwenet), "gigaspeech": (pgigaspeech, jgigaspeech),
           "uwb_atcc": (puwb, juwb), "this_american_life": (ptal, jtal),
           "sbcsae": (psbcsae, jsbcsae)}
TREES = {"wenet_speech": wenet_speech_tree, "gigaspeech": gigaspeech_tree,
         "uwb_atcc": uwb_atcc_tree, "this_american_life": this_american_life_tree,
         "sbcsae": sbcsae_tree}
CASES = {f"{r}-{layout}": (r, layout, {}) for r in RECIPES for layout in ("jaxtest", "wide")}
CASES.update({
    "wenet_speech-wide-S": ("wenet_speech", "wide", {"dataset_parts": ["S"]}),
    "wenet_speech-wide-M-string": ("wenet_speech", "wide", {"dataset_parts": "M"}),
    "wenet_speech-wide-eval": ("wenet_speech", "wide", {
        "dataset_parts": ["TEST_MEETING", "DEV", "TEST_NET"]}),
    "wenet_speech-wide-2jobs": ("wenet_speech", "wide", {"num_jobs": 2}),
    "wenet_speech-wide-no-output": ("wenet_speech", "wide", {"output_dir": None}),
    "gigaspeech-wide-TEST-string": ("gigaspeech", "wide", {"dataset_parts": "TEST"}),
    "gigaspeech-wide-auto": ("gigaspeech", "wide", {"dataset_parts": "auto"}),
    "gigaspeech-wide-2jobs": ("gigaspeech", "wide", {"num_jobs": 2}),
    "uwb_atcc-wide-no-foreign": ("uwb_atcc", "wide", {
        "foreign_sym": None, "unintelligble_sym": None, "partial_sym": None}),
    "uwb_atcc-wide-symbols": ("uwb_atcc", "wide", {
        "silence_sym": "<sil>", "breath_sym": "<breath>", "noise_sym": "<noise>",
        "foreign_sym": "<foreign>", "partial_sym": "<partial>", "unintelligble_sym": "<unint>",
        "unknown_sym": "<unknown>"}),
    "uwb_atcc-wide-no-output": ("uwb_atcc", "wide", {"output_dir": None}),
    "this_american_life-mp3": ("this_american_life", "mp3", {}),
    "this_american_life-wide-no-output": ("this_american_life", "wide", {"output_dir": None}),
    "sbcsae-wide-no-output": ("sbcsae", "wide", {"output_dir": None}),
})


def _fresh_jax_speakers(monkeypatch):
    """JAX's unmapped-speaker counter as in a fresh process (ROADMAP C2)."""
    monkeypatch.setattr(jsbcsae, "dummy_spk_iterator", jsbcsae._DummySpkIterator())


def _prepare(pkg, recipe, args, kwargs, out):
    """One package's ``prepare_*`` after its own ``fix_random_seed(0)``."""
    (fix_random_seed if pkg == "port" else jfix)(0)
    module = MODULES[recipe][pkg == "jax"]
    kwargs = {"output_dir": out, **kwargs}
    return getattr(module, f"prepare_{recipe}")(*args, **kwargs)


def _count(made) -> int:
    if isinstance(made, dict):
        return sum(_count(v) for v in made.values())
    return len(list(made))


def _skip_without_mp3(layout):
    if layout == "mp3" and not _mp3_available():
        pytest.skip("the system MP3 libraries are not present")


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_equals_jax(tmp_path, monkeypatch, request, case):
    """The returned manifests (paths included) and every file that each
    package's ``prepare_*`` writes on the same layout are equal; JAX's
    SBCSAE speaker counter as in a fresh process."""
    recipe, layout, extra = CASES[case]
    _skip_without_mp3(layout)
    if recipe == "gigaspeech":
        request.getfixturevalue("speechcolab")
    _fresh_jax_speakers(monkeypatch)
    args, kwargs = TREES[recipe](tmp_path / "corpus", layout)
    kwargs = {**kwargs, **extra}
    ours = _prepare("port", recipe, args, kwargs, tmp_path / "ours")
    theirs = _prepare("jax", recipe, args, kwargs, tmp_path / "jax")
    assert _dicts(ours) == _dicts(theirs)
    if kwargs.get("output_dir", True) is not None:
        written = _files(tmp_path / "ours")
        assert written and written == _files(tmp_path / "jax")
    assert _count(ours) > 0


def _prep(recipe, tmp_path, layout="wide", **kwargs):
    args, tree_kwargs = TREES[recipe](tmp_path / "corpus", layout)
    return _prepare("port", recipe, args, {**tree_kwargs, **kwargs}, tmp_path / "out"), args


# -- WenetSpeech -----------------------------------------------------------------------------


def test_wenet_speech_nested_subsets_and_files(tmp_path):
    """S ⊂ M ⊂ L by supervision and recording; 12 L, 8 M and 4 S segments;
    the evaluation sets apart; 16 kHz recordings sized from the metadata;
    texts stripped; the segment past its recording trimmed; the
    ``wenetspeech_*_<part>.jsonl.gz`` files."""
    made, (corpus,) = _prep("wenet_speech", tmp_path)
    sups = {part: {s.id: s for s in made[part]["supervisions"]} for part in made}
    recs = {part: {r.id for r in made[part]["recordings"]} for part in made}
    assert {p: len(s) for p, s in sups.items()} == {
        "L": 12, "M": 8, "S": 4, "DEV": 2, "TEST_NET": 2, "TEST_MEETING": 2}
    assert set(sups["S"]) < set(sups["M"]) < set(sups["L"])
    assert recs["S"] == recs["M"] == recs["L"] and len(recs["L"]) == WENET_TRAIN
    assert all(s.text == s.text.strip() and s.language == "Chinese"
               for part in sups.values() for s in part.values())
    for rec in made["L"]["recordings"]:
        assert rec.sampling_rate == SR and rec.num_samples == round(rec.duration * SR)
        assert rec.sources[0].source.startswith(str(corpus / "audio" / "train"))
        assert all(s.end <= rec.duration for s in sups["L"].values() if s.recording_id == rec.id)
    meta = json.loads((corpus / "WenetSpeech.json").read_text())
    past = [seg for a in meta["audios"] for seg in a["segments"] if seg["end_time"] > a["duration"]]
    assert len(past) == 1 and sups["L"][past[0]["sid"]].end < past[0]["end_time"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        f"wenetspeech_{kind}_{part}.jsonl.gz" for kind in ("recordings", "supervisions")
        for part in pwenet.WENET_SPEECH_PARTS)


def test_wenet_speech_unknown_part_raises_as_jax(tmp_path):
    args, _ = wenet_speech_tree(tmp_path / "corpus", "jaxtest")
    for module in (pwenet, jwenet):
        with pytest.raises(ValueError, match="XL"):
            module.prepare_wenet_speech(*args, dataset_parts=["XL"])
    assert pwenet.WETNET_SPEECH_PARTS == pwenet.WENET_SPEECH_PARTS == jwenet.WENET_SPEECH_PARTS


def test_wenet_speech_as_the_jax_test_expects(tmp_path):
    made, _ = _prep("wenet_speech", tmp_path, "jaxtest")
    assert len(made["L"]["supervisions"]) == 2 and len(made["DEV"]["supervisions"]) == 1
    (dev,) = list(made["DEV"]["supervisions"])
    assert dev.text == "大家好" and dev.start == 0.5 and dev.duration == 2.5


# -- GigaSpeech ------------------------------------------------------------------------------


def test_gigaspeech_parse_utterance_equals_jax(tmp_path):
    """tests/test_recipes.py:175's entry and the wide layout's, parsed by
    both packages; no SDK needed."""
    entry = {"aid": "AUD0001", "path": "audio/AUD0001.opus", "sample_rate": 16000,
             "channels": 1, "duration": 10.0,
             "segments": [{"sid": "SEG0001", "begin_time": 0.5, "end_time": 3.25,
                           "speaker": "spk-1", "text_tn": "HELLO WORLD"}]}
    wide = _gigaspeech_entries(tmp_path, "wide", 0)
    for e in [entry] + wide["DEV"] + wide["TEST"]:
        rec, segs = pgigaspeech.parse_utterance(e, "/corpus")
        jrec, jsegs = jgigaspeech.parse_utterance(e, "/corpus")
        assert rec.to_dict() == jrec.to_dict()
        assert [s.to_dict() for s in segs] == [s.to_dict() for s in jsegs]
    rec, segs = pgigaspeech.parse_utterance(entry, "/corpus")
    assert rec.sources[0].source == "/corpus/audio/AUD0001.opus"
    assert segs[0].start == 0.5 and segs[0].duration == 2.75 and segs[0].text == "HELLO WORLD"


def test_gigaspeech_lazy_manifests_and_cached_rerun(speechcolab, tmp_path):
    """Two parts of lazily written recordings, supervisions and cuts; the
    stereo entry's channels; a re-run reads all three back, the cuts too,
    without asking the SDK again, as JAX's does."""
    made, (corpus,) = _prep("gigaspeech", tmp_path)
    assert SDK_CALLS == ["{DEV}", "{TEST}"]
    for part, n in (("DEV", 3), ("TEST", 2)):
        recs, cuts = made[part]["recordings"].to_eager(), made[part]["cuts"].to_eager()
        assert len(recs) == n and len(cuts) == n and len(made[part]["supervisions"]) == 3 * n
        assert all(len(c.supervisions) == 3 for c in cuts)
    stereo = made["DEV"]["recordings"].to_eager()["YOU1000000002"]
    assert stereo.channel_ids == [0, 1] and stereo.load_audio().shape[0] == 2
    again = pgigaspeech.prepare_gigaspeech(corpus, tmp_path / "out", dataset_parts=["DEV", "TEST"])
    jagain = jgigaspeech.prepare_gigaspeech(corpus, tmp_path / "out",
                                            dataset_parts=["DEV", "TEST"])
    assert SDK_CALLS == ["{DEV}", "{TEST}"]
    assert _dicts(again) == _dicts(jagain) == _dicts(made)
    assert set(again["DEV"]) == {"recordings", "supervisions", "cuts"}


def test_gigaspeech_as_the_jax_test_expects(speechcolab, tmp_path):
    made, _ = _prep("gigaspeech", tmp_path, "jaxtest")
    assert set(made) == {"DEV"}
    c = next(c for c in made["DEV"]["cuts"].to_eager() if c.recording_id == "POD0000000001")
    assert c.duration == 3.0 and len(c.supervisions) == 2
    assert c.load_audio().shape == (1, 3 * SR)


def test_gigaspeech_without_sdk_raises_as_jax(tmp_path):
    _clear_module_caches()
    assert not p_module_available("speechcolab")
    for module in (pgigaspeech, jgigaspeech):
        with pytest.raises(ImportError, match="speechcolab"):
            module.prepare_gigaspeech(tmp_path, output_dir=tmp_path)


# -- UWB-ATCC --------------------------------------------------------------------------------


@pytest.mark.parametrize("text", UWB_TEXTS + (
    "lufthansa 4 7 A climb FL 310 [ehm_] roger",
    "[comment_|]ignore me[|_comment] [background_speech_|]hello[|_background_speech] 0.5",
    "speedbirg 1 2 3 4 5 6 7 [unintelligible] VLM QNH [NO_ENG] 1000000"))
def test_uwb_atcc_text_normalize_equals_jax(text):
    for symbols in ({}, {"foreign_sym": None, "unintelligble_sym": None, "partial_sym": None}):
        kwargs = {"silence_sym": "", "breath_sym": "", "noise_sym": "", "foreign_sym": "<unk>",
                  "unintelligble_sym": "<unk>", "partial_sym": "<unk>", "unknown_sym": "<unk>",
                  **symbols}
        assert puwb.text_normalize(text, **kwargs) == juwb.text_normalize(text, **kwargs)


def test_uwb_atcc_text_normalize_as_the_jax_test_expects():
    assert puwb.int_to_words(119) == "ONE HUNDRED NINETEEN" and puwb.int_to_words(40) == "FORTY"
    assert [puwb.int_to_words(n) for n in (0, 17, 1000, 2001, 10 ** 6 + 7)] == [
        juwb.int_to_words(n) for n in (0, 17, 1000, 2001, 10 ** 6 + 7)]
    out = puwb.text_normalize(
        "lufthansa 4 7 A climb FL 310 [ehm_] roger", silence_sym="", breath_sym="",
        noise_sym="", foreign_sym="<unk>", unintelligble_sym="<unk>", partial_sym="<unk>",
        unknown_sym="<unk>")
    assert "FOUR SEVEN ALFA" in out and "FLIGHT LEVEL THREE HUNDRED TEN" in out
    assert "LUFTHANSA" in out and "ROGER" in out and "[" not in out


def test_uwb_atcc_roles_ids_truncated_file_and_missing_recording(tmp_path):
    """Speaker roles and their id suffixes, ids from truncated x100 times,
    the cut-off transcript read, the transcript without a recording
    skipped, the raw text in ``custom``, the section type."""
    made, _ = _prep("uwb_atcc", tmp_path)
    sups = list(made["supervisions"])
    assert sorted(r.id for r in made["recordings"]) == ["ACCU-80UXVV", "TWR-Ab12Cd"]
    assert all(r.sampling_rate == 8000 for r in made["recordings"])
    roles = {s.speaker for s in sups}
    assert roles == {"air", "ground", "air_ground"}
    suffix = puwb.SPEAKER_TO_ID_SUFFIX
    assert all(s.id.endswith(f"_{suffix[s.speaker]}") for s in sups)
    # 0.29 x 100 is 28.999..., which "%06d" truncates.
    assert any(s.id.startswith("uwb-atcc_TWR-Ab12Cd_000028_") for s in sups)
    assert {s.recording_id for s in sups} == {"ACCU-80UXVV", "TWR-Ab12Cd"}
    assert all(s.custom["type"] in ("report", "nontrans") and s.custom["orig_text"] for s in sups)
    assert not any(s.text == "" or "[" in s.text for s in sups)
    assert len(sups) == 2 * (len(UWB_TEXTS) - 2)  # two texts dropped in each recording
    assert (tmp_path / "out" / "uwb_atcc_supervisions_all.jsonl.gz").is_file()


@pytest.mark.parametrize("symbols,expected", [
    ({}, "<unk>"),
    ({"foreign_sym": None}, "DOBRY DEN"),
    ({"foreign_sym": "<foreign>"}, "<foreign>"),
])
def test_uwb_atcc_foreign_symbol_options(tmp_path, symbols, expected):
    made, _ = _prep("uwb_atcc", tmp_path, **symbols)
    (sup,) = [s for s in made["supervisions"]
              if s.recording_id == "TWR-Ab12Cd" and "dobr" in s.custom["orig_text"]]
    assert expected in sup.text


def test_uwb_atcc_as_the_jax_test_expects(tmp_path):
    made, _ = _prep("uwb_atcc", tmp_path, "jaxtest")
    sups = sorted(made["supervisions"], key=lambda s: s.start)
    assert len(sups) == 2
    assert sups[0].speaker == "ground" and sups[0].id.endswith("_AT")
    assert sups[0].start == 0.5 and sups[0].end == 3.0 and "CONTACT PRAHA" in sups[0].text
    assert sups[1].speaker == "air" and sups[1].end == 10.0


# -- This American Life ----------------------------------------------------------------------


def _treebank(monkeypatch):
    """nltk's word tokenizer without its sentence splitter (whose data this
    machine lacks), for both packages."""
    import nltk
    from nltk.tokenize import TreebankWordTokenizer

    monkeypatch.setattr(nltk, "word_tokenize", TreebankWordTokenizer().tokenize)


def _nltk_loads() -> bool:
    """Whether nltk's ``word_tokenize`` runs here (it needs its punkt data)."""
    try:
        from nltk import word_tokenize

        word_tokenize("a b")
        return True
    except (ImportError, LookupError):
        return False


def _no_nltk(monkeypatch):
    for module in (ptal, jtal):
        monkeypatch.setattr(module, "is_module_available", lambda *names: False)


@pytest.mark.parametrize("tokenizer", ["nltk", "treebank", "regex"])
def test_this_american_life_tokenizers_equal_jax(tmp_path, monkeypatch, tokenizer):
    """Under nltk as installed, under nltk's Treebank tokenizer and under
    the regex (nltk forced unavailable in both packages), the manifests and
    files of both packages are equal; each route gives its own tokens."""
    if tokenizer == "treebank":
        _treebank(monkeypatch)
    elif tokenizer == "regex":
        _no_nltk(monkeypatch)
    args, _ = this_american_life_tree(tmp_path / "corpus")
    ours = _prepare("port", "this_american_life", args, {}, tmp_path / "ours")
    theirs = _prepare("jax", "this_american_life", args, {}, tmp_path / "jax")
    assert _dicts(ours) == _dicts(theirs)
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")
    words = {s.id: [a.symbol for a in s.alignment["word"]]
             for part in ours.values() for s in part["supervisions"]}
    dont = next(w for w in words.values() if "do" in w or "don't" in w)
    assert ("n't" in dont) == (tokenizer == "treebank" or tokenizer == "nltk" and _nltk_loads())
    assert ptal._tokenize("Well, I don't know.") == jtal._tokenize("Well, I don't know.")


def test_this_american_life_parts_missing_episode_and_alignments(tmp_path):
    """train/dev/test from the train, valid and test files; the episode
    without its MP3 skipped; each word of the alignment from its token
    index, the index past the tokens dropped."""
    made, (corpus,) = _prep("this_american_life", tmp_path)
    assert {p: sorted(r.id for r in made[p]["recordings"]) for p in made} == {
        "train": ["ep-100", "ep-101"], "dev": ["ep-200"], "test": ["ep-300"]}
    (test_sup,) = list(made["test"]["supervisions"])
    utt = json.loads((corpus / "test-transcripts-aligned.json").read_text())["ep-300"][0]
    assert len(test_sup.alignment["word"]) == len(utt["alignments"]) - 1
    assert all(s.language == "en" and s.channel == 0 for p in made.values()
               for s in p["supervisions"])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        f"this-american-life_{k}_{p}.jsonl.gz" for k in ("recordings", "supervisions")
        for p in ("train", "dev", "test"))


def test_this_american_life_as_the_jax_test_expects(tmp_path):
    made, _ = _prep("this_american_life", tmp_path, "jaxtest")
    (s,) = list(made["train"]["supervisions"])
    assert s.speaker == "host" and s.start == 1.0 and s.duration == 2.0
    assert [a.symbol for a in s.alignment["word"]] == ["hello", "world"]
    assert len(list(made["dev"]["supervisions"])) == 0
    assert list(ptal.included_episodes(*_)) == list(jtal.included_episodes(*_)) == ["ep-1"]


# -- SBCSAE ----------------------------------------------------------------------------------


def test_sbcsae_channels_speakers_and_languages(tmp_path, monkeypatch):
    """The channel rule (stereo [0, 1]; mono and ``bad_stereo`` channel 0),
    the speaker tables of Parts 1-4 (genders, global ids, the Dan erratum,
    Part 3 paired by row), unmapped speakers numbered from 0214 in order,
    SBC021's unmapped speaker numbered anew on each line (kept as JAX has
    it), and the language of each code-switched line."""
    made, _ = _prep("sbcsae", tmp_path)
    sups = {s.id: s for s in made["supervisions"]}
    by_reco = {}
    for s in sups.values():
        by_reco.setdefault(s.recording_id, []).append(s)
    channels = {reco: {str(s.channel) for s in ss} for reco, ss in by_reco.items()}
    assert channels == {"SBC001": {"[0, 1]"}, "SBC004": {"0"}, "SBC020": {"0"},
                        "SBC021": {"0"}, "SBC035": {"0"}, "SBC047": {"0"}}
    speakers = {(s.recording_id, s.speaker, s.gender) for s in sups.values()}
    assert {("SBC001", "0001_LENORE", "F"), ("SBC001", "0002_LYNNE", "F"),
            ("SBC001", "0003_DORIS", "F"), ("SBC004", "0010_KATHY", "F"),
            ("SBC004", "0011_NATHAN", "M"), ("SBC020", "0050_JAMIE", "F"),
            ("SBC020", "0051_HAROLD", "M"), ("SBC020", "SBC020_AUD", None),
            ("SBC021", "0052_RICKIE", None), ("SBC021", "SBC021_MANY", None),
            ("SBC035", "0120_FRANK", "M"), ("SBC035", "0121_MELISSA", "F"),
            ("SBC047", "0166_DAN", "M"), ("SBC047", "0167_ALINA", "F")} <= speakers
    unmapped = sorted(s.speaker for s in sups.values() if s.speaker.startswith("02"))
    assert unmapped == ["0214_KEN", "0214_KEN", "0215_UNK", "0216_JOE", "0217_JOE"]
    sbc004 = sorted(by_reco["SBC004"], key=lambda s: s.start)
    assert [s.language for s in sbc004] == [
        "English-Spanish", "Spanish", "Spanish", "English-Spanish", "English"]
    assert "<L2 hola L2>" in sbc004[0].text and "se\xf1orita" in sbc004[0].text
    lynne = next(s for s in by_reco["SBC001"] if s.speaker == "0002_LYNNE" and s.start == 5.1)
    assert "<LAUGH>" in lynne.text and "<UNK>" in lynne.text
    assert not any(s.start == 12.0 for s in by_reco["SBC001"])  # the " $ " line
    assert not any(s.start == 0.0 for s in by_reco["SBC001"])  # the "0.00 0.00" line
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "sbcsae_recordings.jsonl.gz", "sbcsae_supervisions.jsonl.gz"]


def test_sbcsae_as_the_jax_test_expects(tmp_path):
    made, _ = _prep("sbcsae", tmp_path, "jaxtest")
    sups = sorted(made["supervisions"], key=lambda s: s.start)
    assert len(sups) == 2
    assert sups[0].speaker == "0001_LENORE" and sups[0].gender == "F"
    assert sups[1].speaker == "0001_LENORE" and "borrow equipment" in sups[0].text


@pytest.mark.parametrize("transcript", [
    "... And then [2he said2],", "you know @ @@ what X .", "he said <L2 hola L2> there",
    "<L2 Buenos dias L2>", "<L2 Como estas,", "muy bien L2> okay.", "(H) <VOX hey VOX> X-",
    "[3@@@3] (TSK) ((SNIFF)) %uh =so", "<@ ha @> you@ know"])
def test_sbcsae_parse_raw_transcript_equals_jax(transcript):
    assert psbcsae._parse_raw_transcript(transcript) == jsbcsae._parse_raw_transcript(transcript)


def test_sbcsae_speaker_tables_equal_jax(tmp_path):
    sbcsae_tree(tmp_path)
    doc_dir = tmp_path / "SBCSAE" / "docs"
    assert psbcsae.generate_speaker_map_dicts(doc_dir) == jsbcsae.generate_speaker_map_dicts(
        doc_dir)
    for line in ("1.00 3.50\tLENORE:\tSo,", "3.50 4.20\t\t.. from anybody.",
                 "8.00 9.50 DORIS: Right,", "5.10\t6.40\tLYNNE:\tYeah", "6.4\t7.9\tX Y",
                 "garbage", "1.0 2.0\tKEN: hi", "1.0\t2.0\tKEN: hi there"):
        assert psbcsae._parse_time_speaker(line) == jsbcsae._parse_time_speaker(line)


def _jax_sbcsae_twice(corpus) -> list:
    """JAX's unmapped speakers of two ``prepare_sbcsae`` calls in a fresh
    process."""
    code = ("import os, json, sys; os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            "from lhotse_tpu.recipes.sbcsae import prepare_sbcsae\n"
            "runs = [sorted(s.speaker for s in prepare_sbcsae(sys.argv[1], "
            "omit_realignments=True)['supervisions'] if s.speaker.startswith('02')) "
            "for _ in range(2)]\n"
            "print(json.dumps(runs))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(corpus)], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sbcsae_unmapped_speaker_ids_do_not_depend_on_earlier_calls(tmp_path):
    """ROADMAP C2: JAX keeps the counter of unmapped speakers in a module
    global, so two calls in one process name ``KEN`` 0214_KEN, then
    0215_KEN. The port starts the counter afresh in each call: its ids are
    the same in both calls, each equal to JAX's first call in a fresh
    process."""
    (corpus,), _ = sbcsae_tree(tmp_path / "corpus", "short")
    jax_runs = _jax_sbcsae_twice(corpus)
    assert jax_runs == [["0214_KEN"], ["0215_KEN"]]
    port_runs = [sorted(s.speaker for s in psbcsae.prepare_sbcsae(
        corpus, omit_realignments=True)["supervisions"] if s.speaker.startswith("02"))
        for _ in range(2)]
    assert port_runs == [jax_runs[0], jax_runs[0]]


def test_sbcsae_short_segment_padded_to_20_ms(tmp_path, monkeypatch):
    """ROADMAP C2: a 10 ms segment at 10.000 s of a 30 s recording. JAX
    passes the padded end time as the duration: the segment starts at 9.99
    s and ends at 20.0 s. The port's lasts 20 ms, from 9.99 to 10.01 s. The
    other supervisions are equal."""
    _fresh_jax_speakers(monkeypatch)
    args, kwargs = sbcsae_tree(tmp_path / "corpus", "short")
    ours = {s.id: s for s in _prepare("port", "sbcsae", args, kwargs, None)["supervisions"]}
    theirs = {s.id: s for s in _prepare("jax", "sbcsae", args, kwargs, None)["supervisions"]}
    short = "SBC001_0010000_0010010_KEN"
    assert sorted(ours) == sorted(theirs) and short in ours
    assert (theirs[short].start, theirs[short].end) == pytest.approx((9.99, 20.0))
    assert (ours[short].start, ours[short].end) == pytest.approx((9.99, 10.01))
    assert ours[short].duration == pytest.approx(0.02)
    assert all(ours[k].to_dict() == theirs[k].to_dict() for k in ours if k != short)
    # At a recording's end, the padding stops there.
    seg = SupervisionSegment("s", "SBC001", start=29.995, duration=0.005)
    monkeypatch.setattr(psbcsae, "_filename_to_supervisions", lambda *a, **k: [seg])
    (end,) = list(psbcsae.prepare_sbcsae(args[0], omit_realignments=True)["supervisions"])
    assert (end.start, end.end) == pytest.approx((29.985, 30.0))


def test_sbcsae_stereo_cuts_downmix_into_training(tmp_path, monkeypatch):
    """ROADMAP C2: a stereo SBCSAE cut trimmed to its supervision and
    downmixed with ``to_mono(mono_downmix=True)``, as a user feeds it to the
    extractors (which take one channel). JAX's downmix holds the
    supervision twice, once per channel, both naming the source recording
    instead of the rendered one, so ``validate`` refuses the cut. The
    port's holds it once, on the rendered recording, and the cuts go
    through ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures``, one
    row each, their audio the sum of both channels."""
    from lhotse_tpu_torch.dataset import K2SpeechRecognitionDataset, OnTheFlyFeatures
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.qa import validate

    _fresh_jax_speakers(monkeypatch)
    args, kwargs = sbcsae_tree(tmp_path / "corpus")
    trimmed = {}
    for pkg, CS in (("port", CutSet), ("jax", J.CutSet)):
        m = _prepare(pkg, "sbcsae", args, kwargs, None)
        trimmed[pkg] = [c for c in CS.from_manifests(
            recordings=m["recordings"], supervisions=m["supervisions"]
        ).trim_to_supervisions(keep_overlapping=False) if c.num_channels > 1]
    assert len(trimmed["port"]) == len(trimmed["jax"]) == 7  # SBC001's supervisions
    ours = [c.to_mono(mono_downmix=True) for c in trimmed["port"]]
    theirs = [c.to_mono(mono_downmix=True) for c in trimmed["jax"]]
    for o, t, c in zip(ours, theirs, trimmed["port"]):
        assert [s.id for s in o.supervisions] == [c.supervisions[0].id]
        assert o.supervisions[0].recording_id == o.recording_id != c.recording_id
        assert [s.id for s in t.supervisions] == [c.supervisions[0].id] * 2
        assert {s.recording_id for s in t.supervisions} == {c.recording_id} != {t.recording_id}
        assert np.array_equal(o.load_audio(), t.load_audio())
        np.testing.assert_allclose(o.load_audio()[0], c.load_audio().sum(axis=0), atol=2.0 ** -15)
    with pytest.raises(AssertionError, match="recording_id"):
        J.qa.validate(J.CutSet.from_cuts(theirs))
    validate(CutSet.from_cuts(ours))
    batch = K2SpeechRecognitionDataset(input_strategy=OnTheFlyFeatures(
        Fbank(FbankConfig(device="cpu"))))[CutSet.from_cuts(ours)]
    assert batch["inputs"].shape[0] == len(ours) == len(batch["supervisions"]["text"])


def test_sbcsae_network_paths_raise_naming_their_urls(tmp_path):
    """The realignments (the default) raise after the manifests are written,
    naming the STM file JAX fetches; geolocation raises naming Nominatim;
    both URLs are JAX's."""
    (corpus,), _ = sbcsae_tree(tmp_path / "corpus", "jaxtest")
    with pytest.raises(NotImplementedError, match="aligned_for_asr.stm"):
        psbcsae.prepare_sbcsae(corpus, output_dir=tmp_path / "out")
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "sbcsae_recordings.jsonl.gz", "sbcsae_supervisions.jsonl.gz"]
    with pytest.raises(NotImplementedError, match="nominatim.openstreetmap.org"):
        psbcsae.prepare_sbcsae(corpus, geolocation=True, omit_realignments=True)
    for url in psbcsae.STM_URLS.values():
        with pytest.raises(NotImplementedError, match=url):
            psbcsae.retrieve_stm_file(url)
    strings = [n.value for n in ast.walk(ast.parse(inspect.getsource(
        jsbcsae.apply_aligned_stms))) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    base = next(v for v in strings if v.startswith("https://"))
    assert sorted(psbcsae.STM_URLS.values()) == [
        base + v for v in strings if v.endswith(".stm")]
    assert "Nominatim" in inspect.getsource(jsbcsae.generate_geolocations)


def test_sbcsae_stm_helpers_equal_jax():
    stm = ("SBC001 1 0001_LENORE 1.02 3.48 so you don't need to go\n"
           "SBC001 1 0002_LYNNE 5.10 6.42 yeah <LAUGH>\n\n")
    ours, theirs = psbcsae.parse_stm_file(stm), jsbcsae.parse_stm_file(stm)
    assert [vars(s) for s in ours] == [vars(s) for s in theirs] and len(ours) == 2
    seg = SupervisionSegment("s", "SBC001", start=1.0, duration=2.5, text=" So You ")
    assert psbcsae.compute_iou(seg, ours[0]) == jsbcsae.compute_iou(seg, theirs[0])
    assert psbcsae.norm_txt(seg.text) == jsbcsae.norm_txt(seg.text) == "so you"
    have = p_module_available("intervaltree") and p_module_available("jiwer")
    sups = SupervisionSet.from_segments([seg])
    if have:
        assert _dicts(psbcsae.apply_stm(["SBC001"], sups, ours)) == _dicts(
            jsbcsae.apply_stm(["SBC001"], sups, theirs))
    else:
        for module, segs in ((psbcsae, ours), (jsbcsae, theirs)):
            with pytest.raises(ImportError):
                module.apply_stm(["SBC001"], sups, segs)


def test_downloads_are_left_out():
    """The port defines none of the JAX modules' downloads, and its modules
    use no network library."""
    for recipe, (port, jax_module) in MODULES.items():
        name = f"download_{recipe}"
        assert hasattr(jax_module, name) == (recipe != "wenet_speech"), name
        assert not hasattr(port, name), name
        source = open(port.__file__).read()
        for word in ("urllib", "urlopen", "requests", "resumable_download", "rarfile",
                     "subprocess", "geopy", "bs4"):
            assert word not in source, (recipe, word)
    assert not hasattr(ptal, "scrape_urls") and not hasattr(puwb, "safe_extract_rar")


# -- the prepare commands --------------------------------------------------------------------

COMMANDS = {
    # command: (argv after the corpus, the layout maker, the function's keyword arguments)
    "wenet-speech": (["-p", "L", "--dataset-parts", "DEV", "-j", "2"], wenet_speech_tree,
                     {"dataset_parts": ["L", "DEV"], "num_jobs": 2}),
    "wenet-speech-default": ([], wenet_speech_tree, {"dataset_parts": ["all"]}),
    "gigaspeech": (["-p", "DEV", "--subset", "TEST"], gigaspeech_tree,
                   {"dataset_parts": ["DEV", "TEST"]}),
    "gigaspeech-one-part": (["--dataset-parts", "TEST"], gigaspeech_tree,
                            {"dataset_parts": "TEST"}),
    "uwb-atcc": (["--silence-sym", "<sil>", "--breath-sym", "<b>", "--noise-sym", "<n>",
                  "--foreign-sym", "<f>", "--partial-sym", "<p>", "--unintelligble-sym", "<i>",
                  "--unknown-sym", "<u>"], uwb_atcc_tree,
                 {"silence_sym": "<sil>", "breath_sym": "<b>", "noise_sym": "<n>",
                  "foreign_sym": "<f>", "partial_sym": "<p>", "unintelligble_sym": "<i>",
                  "unknown_sym": "<u>"}),
    "uwb-atcc-default": ([], uwb_atcc_tree, {}),
    "this-american-life": ([], this_american_life_tree, {}),
    "sbcsae": (["--omit-realignments"], sbcsae_tree, {"omit_realignments": True}),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_prepare_command_writes_what_its_function_writes(tmp_path, monkeypatch, request, name):
    """Each ``prepare`` command writes the files its function writes, and
    the JAX CLI's command the same, with the output directory replaced."""
    from test_torch_cli import _both as both_clis

    options, build, kwargs = COMMANDS[name]
    command = name.replace("-default", "").replace("-one-part", "")
    recipe = command.replace("-", "_")
    if recipe == "gigaspeech":
        request.getfixturevalue("speechcolab")
    args, _ = build(tmp_path / "corpus", "wide")
    _fresh_jax_speakers(monkeypatch)
    runs = both_clis(tmp_path, "prepare", command, *args, "{out}", *options)
    _prepare("port", recipe, args, kwargs, tmp_path / "function")
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    ours = _files(pout)
    assert ours and ours == _files(tmp_path / "function") == _files(jout)


def test_sbcsae_command_without_omit_realignments_raises(tmp_path):
    """The port's command keeps JAX's default, whose realignments need the
    network: without ``--omit-realignments`` it raises."""
    from lhotse_tpu_torch.bin.modes import cli

    (corpus,), _ = sbcsae_tree(tmp_path / "corpus", "jaxtest")
    with pytest.raises(NotImplementedError, match="omit-realignments"):
        cli.main(["prepare", "sbcsae", str(corpus), str(tmp_path / "out")],
                 standalone_mode=False)


# -- the slice: WenetSpeech into the on-device chain -----------------------------------------


@pytest.fixture(scope="module")
def wenet_slice(tmp_path_factory):
    root = tmp_path_factory.mktemp("wenet_slice")
    args, kwargs = wenet_speech_tree(root / "corpus")
    made = {}
    for pkg, CS in (("port", CutSet), ("jax", J.CutSet)):
        m = _prepare(pkg, "wenet_speech", args, kwargs, root / pkg)
        made[pkg] = CS.from_manifests(
            recordings=m["L"]["recordings"], supervisions=m["L"]["supervisions"]
        ).trim_to_supervisions().to_eager()
    return root, list(made["port"]), list(made["jax"])


def test_wenet_speech_segments_through_the_augmenter_equal_jax(wenet_slice):
    """WenetSpeech's 12 L segments (1-2.5 s, one trimmed at its recording's
    end), trimmed from their long recordings, in batches of the 3 s x 4
    bucket through each package's augmenter with the same MUSAN noise pool
    and real RIR, speed 1.1, SNR (10, 20) and SpecAugment: the port within
    ``AUG_TOL`` of the JAX augmenter whose fbank stage is its kernel route
    in float64."""
    root, ours, theirs = wenet_slice
    strip = (lambda c: {k: v for k, v in c.to_dict().items() if k != "id"})
    assert [strip(c) for c in ours] == [strip(c) for c in theirs] and len(ours) == 12
    assert all(0.5 <= c.duration <= 2.5 for c in ours)
    musan, rirs = musan_tree(root / "musan", "pool"), rir_noise_tree(root / "RIRS", 2)
    pool = noise_pool(pmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"])
    rir = seeded_rir(prir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"])
    assert np.array_equal(
        pool, noise_pool(jmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"]))
    assert np.array_equal(
        rir, seeded_rir(jrir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"]))
    common = dict(speed_factor=1.1, noise_pool=pool, rir=rir, snr=(10, 20), mix_prob=0.5, seed=5,
                  wire_format="int16")
    port = OnDeviceAugmenter([(3.0, 4)], specaugment=SpecAugment(seed=7), device="cpu", **common)
    jax_aug = JAugmenter([(3.0, 4)], specaugment=JSpecAugment(seed=7), fbank=_JaxKernelRoute64(),
                         **common)
    batches = _bucketed(ours, (3.0, 4))
    for (audio, lens), (jaudio, jlens) in zip(batches, _bucketed(theirs, (3.0, 4))):
        assert np.array_equal(audio, jaudio) and np.array_equal(lens, jlens)
    mixed = 0
    for audio, lens in batches:
        s_ours, s_theirs = port.stage(audio, lens), jax_aug.stage(audio, lens)
        mixed += int(np.asarray(s_ours.kwargs["mix_mask"]).sum())
        feats, feat_lens = port.compute(s_ours)
        jfeats, jfeat_lens = jax_aug.compute(s_theirs)
        feats, jfeats = feats.numpy(), np.asarray(jfeats)
        assert feats.shape == jfeats.shape and np.isfinite(feats).all()
        assert np.array_equal(feat_lens.numpy(), np.asarray(jfeat_lens))
        np.testing.assert_allclose(feats, jfeats, rtol=0, atol=AUG_TOL)
    assert mixed > 0
