"""
The port's LDC telephone and broadcast recipes (lhotse_tpu_torch.recipes
``switchboard``, ``eval2000``, ``fisher_english``, ``fisher_spanish``,
``callhome_english``, ``callhome_egyptian``, ``gale_arabic``,
``gale_mandarin``, ``mgb2`` and ``broadcast_news``) against the JAX
package's, on the fixture layouts of tests/test_recipes.py:453,485,
tests/test_recipes_tranche12.py:14, tests/test_recipes_tranche2.py:500,
tests/test_recipes_tranche3.py:161-341, tests/test_recipes_tranche4.py:234,
tests/test_recipes_tranche15.py:27 and the cases of
tests/test_refdiff_recipes.py (made from the same numpy seeds), and on wider
layouts of the same formats: two-channel 8 kHz mu-law and 16-bit PCM
SPHERE, and the WAV bytes under a ``.sph`` name that some JAX tests write.
Also their helpers (``check_and_rglob``, ``recursion_limit``, the TDF
parser, the MGB-2 text cleaners, the RTTM and SGML readers) against JAX's;
their ``prepare`` commands through both CLIs; a shorten-coded SPHERE file,
which neither package decodes; and the slice as a whole at a small size:
Switchboard and Fisher English conversations trimmed to their
supervisions, resampled to 16 kHz and muxed (``CutSet.mux``, the same seed
in each package), through each package's ``OnDeviceAugmenter`` with the
same MUSAN noise pool and RIR (within ``AUG_TOL`` of the JAX augmenter with
its fbank layer's kernel route in float64) and through
``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures`` (within
``EXTRACTOR_TOL`` of the JAX chain with its extractor's device route).

GALE Mandarin reads its dev ids from the network in every call
(``_fetch_dev_ids``): every test here replaces it in both packages with
pytest's ``monkeypatch``, which puts it back afterwards.
"""
import gzip
import sys

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac
from lhotse_tpu.audio.sphio import write_sph
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import _tdf as jtdf
from lhotse_tpu.recipes import broadcast_news as jbn
from lhotse_tpu.recipes import callhome_egyptian as jche
from lhotse_tpu.recipes import callhome_english as jchen
from lhotse_tpu.recipes import eval2000 as jeval2000
from lhotse_tpu.recipes import fisher_english as jfisher
from lhotse_tpu.recipes import fisher_spanish as jfsp
from lhotse_tpu.recipes import gale_arabic as jgale_ar
from lhotse_tpu.recipes import gale_mandarin as jgale_zh
from lhotse_tpu.recipes import mgb2 as jmgb2
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.recipes import switchboard as jswbd
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch import utils as putils
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import _tdf as ptdf
from lhotse_tpu_torch.recipes import broadcast_news as pbn
from lhotse_tpu_torch.recipes import callhome_egyptian as pche
from lhotse_tpu_torch.recipes import callhome_english as pchen
from lhotse_tpu_torch.recipes import eval2000 as peval2000
from lhotse_tpu_torch.recipes import fisher_english as pfisher
from lhotse_tpu_torch.recipes import fisher_spanish as pfsp
from lhotse_tpu_torch.recipes import gale_arabic as pgale_ar
from lhotse_tpu_torch.recipes import gale_mandarin as pgale_zh
from lhotse_tpu_torch.recipes import mgb2 as pmgb2
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.recipes import switchboard as pswbd
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_recipes_asr import _dicts
from test_torch_recipes_noise import (
    AUG_TOL, EXTRACTOR_TOL, musan_tree, noise_pool, rir_noise_tree, seeded_rir)
from test_torch_recipes_zh import _JaxKernelRoute64, _bucketed

SR = 16000
TEL = 8000
ENGLISH = ("yeah", "right", "uh", "huh", "i", "think", "so", "you", "know", "the", "weather")


def _signal(seconds, sr, seed, channels=1):
    """tests/test_recipes*.py::_wav's signal: 0.1 white noise from RandomState(seed)."""
    return (np.random.RandomState(seed).randn(channels, int(seconds * sr)) * 0.1).astype(
        np.float32)


def _audio(path, seconds, sr=SR, seed=0, channels=1, fmt="wav", coding="pcm16", x=None):
    """``x`` (or ``_signal``) written to ``path`` as ``fmt``, whatever its
    suffix: "wav", "flac", or "sph" in the SPHERE ``coding``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    x = _signal(seconds, sr, seed, channels) if x is None else x
    if fmt == "sph":
        write_sph(str(path), x, sr, coding=coding)
    elif fmt == "flac":
        write_flac(path, x, sr)
    else:
        write_wav(path, x, sr)
    return path


def _words(rng, lo=2, hi=7):
    return " ".join(ENGLISH[i] for i in rng.randint(0, len(ENGLISH), rng.randint(lo, hi)))


# -- the JAX tests' layouts, and wider ones of the same formats --------------------------


def switchboard_tree(root, layout="tranche12"):
    """``recipes``: tests/test_recipes.py:453 (WAV bytes under the ``.sph``
    name, transcripts two directories down); ``tranche12``:
    tests/test_recipes_tranche12.py:14 (8 kHz SPHERE); ``refdiff``:
    tests/test_refdiff_recipes.py:695 (the same at 16 kHz); ``wide``: three
    conversations of two-channel 8 kHz mu-law SPHERE, [silence] rows on both
    sides, and LDC2020T14 sentiment labels. Returns the arguments of
    ``prepare_switchboard`` but ``output_dir``."""
    if layout == "recipes":
        audio = root / "LDC97S62"
        rng = np.random.RandomState(70)
        _audio(audio / "sw02001.sph", 0, TEL, x=(rng.randn(2, 16000) * 0.1).astype(np.float32))
        trans = root / "swb_ms98_transcriptions" / "20" / "2001"
        trans.mkdir(parents=True)
        (trans / "sw2001A-ms98-a-trans.text").write_text(
            "sw2001A-ms98-a-0001 0.00 1.00 [silence]\n"
            "sw2001A-ms98-a-0002 1.00 1.90 hello there\n")
        (trans / "sw2001B-ms98-a-trans.text").write_text(
            "sw2001B-ms98-a-0001 0.50 1.80 hi yourself\n")
        return (audio,), {"transcripts_dir": root / "swb_ms98_transcriptions",
                          "absolute_paths": True}
    audio, trans = root / "audio", root / "trans"
    trans.mkdir(parents=True)
    if layout in ("tranche12", "refdiff"):
        rng = np.random.RandomState(0)
        sr = TEL if layout == "tranche12" else SR
        _audio(audio / "sw02001.sph", 0, sr, fmt="sph",
               x=(0.1 * rng.randn(2, 4 * sr)).astype(np.float32))
        (trans / "sw2001A-ms98-a-trans.text").write_text(
            "sw2001A-ms98-a-0001 0.00 1.50 hello there\n"
            "sw2001A-ms98-a-0002 1.50 2.00 [silence]\n"
            "sw2001A-ms98-a-0003 2.00 3.75 how are you\n")
        (trans / "sw2001B-ms98-a-trans.text").write_text(
            "sw2001B-ms98-a-0001 0.50 2.20 fine thanks\n")
        return (audio,), {"transcripts_dir": trans, "absolute_paths": True}
    rng = np.random.RandomState(2001)
    labels = []
    for k, conv in enumerate(("2001", "2005", "3010")):
        _audio(audio / f"sw0{conv}.sph", 6.0, TEL, seed=20 + k, channels=2, fmt="sph",
               coding="ulaw")
        for side in "AB":
            rows, t = [], 0.0
            for i in range(4):
                end = round(t + rng.uniform(0.4, 1.4), 2)
                words = "[silence]" if i == 1 else _words(rng)
                rows.append(f"sw{conv}{side}-ms98-a-{i + 1:04d} {t:.2f} {end:.2f} {words}")
                t = end
            (trans / conv[:2] / conv).mkdir(parents=True, exist_ok=True)
            (trans / conv[:2] / conv / f"sw{conv}{side}-ms98-a-trans.text").write_text(
                "\n".join(rows) + "\n")
        labels.append(f"sw0{conv}_0\t0.00\t2.50\tNeutral#Positive#Neutral")
    labels.append("sw09999_0\t0.00\t1.00\tNegative")  # a call that is not in the corpus
    labels.append("a short row")
    sentiment = root / "LDC2020T14"
    (sentiment / "data").mkdir(parents=True)
    (sentiment / "data" / "sentiment_labels.tsv").write_text("\n".join(labels) + "\n")
    return (audio,), {"transcripts_dir": trans, "sentiment_dir": sentiment}


def eval2000_tree(root, layout="refdiff"):
    """``recipes``: tests/test_recipes.py:485 (WAV bytes under ``.sph``);
    ``refdiff``: tests/test_refdiff_recipes.py:1031 (8 kHz SPHERE); ``wide``:
    three two-channel 8 kHz mu-law conversations with ``#`` and blank lines,
    the transcripts outside the corpus directory."""
    audio = root / "LDC2002S09" / "hub5e_00" / "english"
    trans = root / "LDC2002T43" / "reference" / "english"
    if layout != "wide":
        rng = np.random.RandomState(71)
        _audio(audio / "en_4156.sph", 0, TEL, fmt="wav" if layout == "recipes" else "sph",
               x=(rng.randn(2, 16000) * 0.1).astype(np.float32))
        trans.mkdir(parents=True)
        (trans / "en_4156.txt").write_text(
            "# header line\n\n0.00 1.10 A: yeah right\n1.10 1.95 B: uh huh\n")
        return (root,), {"absolute_paths": True}
    rng = np.random.RandomState(2000)
    trans = root / "elsewhere" / "english"
    trans.mkdir(parents=True)
    for k, conv in enumerate(("en_4156", "en_4170", "sw_4390")):
        _audio(audio / f"{conv}.sph", 5.0, TEL, seed=30 + k, channels=2, fmt="sph",
               coding="ulaw")
        rows, t = ["# Hub5'00 reference", ""], 0.1
        for i in range(6):
            end = round(t + rng.uniform(0.3, 0.9), 2)
            rows.append(f"{t:.2f} {end:.2f} {'AB'[i % 2]}: {_words(rng)}")
            t = end
        (trans / f"{conv}.txt").write_text("\n".join(rows) + "\n")
    return (root,), {"transcript_path": trans}


def _fisher_call(audio_root, trans_root, part, session, seconds, seed, rng, fmt, sr, coding):
    stem = f"fe_03_{session}"
    _audio(audio_root / "audio" / session[:3] / f"{stem}.sph", seconds, sr, seed=seed,
           channels=2, fmt=fmt, coding=coding)
    rows, t = [], 0.0
    for i in range(5):
        end = round(t + rng.uniform(0.3, 0.9), 2)
        rows.append(f"{t:.2f} {end:.2f} {'AB'[i % 2]}: {_words(rng)}")
        t = end
    if session == "11487":  # the row whose start _fix_known_typos repairs
        rows.append("31.09 234.06 A: known typo")
    tdir = trans_root / f"fe_03_{part}_tran" / "data" / "trans" / session[:3]
    tdir.mkdir(parents=True, exist_ok=True)
    (tdir / f"{stem}.txt").write_text(f"# {stem}.sph\n# Transcribed at the LDC\n\n"
                                      + "\n".join(rows) + "\n")


def fisher_english_tree(root, layout="refdiff"):
    """``tranche2``: tests/test_recipes_tranche2.py:500 (WAV bytes under
    ``.sph``); ``refdiff``: tests/test_refdiff_recipes.py:2447 (SPHERE);
    ``wide``: parts 1 and 2 (LDC2004S13/T19 and LDC2005S13/T19), two calls of
    two-channel 8 kHz mu-law SPHERE each, one of them the call whose
    transcript has a known typo (session 11487, 240 s)."""
    if layout != "wide":
        stem = "fe_03_00001"
        rng = np.random.RandomState(91)
        _audio(root / "LDC2004S13" / "audio" / "000" / f"{stem}.sph", 0, SR,
               fmt="wav" if layout == "tranche2" else "sph",
               x=(0.1 * rng.randn(2, 3 * SR)).astype(np.float32) if layout == "refdiff"
               else _signal(3.0, SR, 91, channels=2))
        tdir = root / "LDC2004T19" / "fe_03_p1_tran" / "data" / "trans" / "000"
        tdir.mkdir(parents=True)
        (tdir / f"{stem}.txt").write_text(
            "# header\n#\n#\n0.00 1.20 A: hello there\n1.20 2.40 B: hi how are you\n")
        doc = root / "LDC2004T19" / "doc"
        doc.mkdir(parents=True)
        (doc / "fe_03_p1_calldata.tbl").write_text(
            "CALL_ID,h1,h2,h3,h4,APIN,h6,h7,h8,h9,BPIN\n00001,x,x,x,x,9001,x,x,x,x,9002\n")
        return (root,), {"audio_dirs": ["LDC2004S13"], "transcript_dirs": ["LDC2004T19"],
                         "absolute_paths": True}
    rng = np.random.RandomState(2004)
    calls = {"p1": ("00001", "00002"), "p2": ("05851", "11487")}
    for (part, sessions), a_dir, t_dir in zip(calls.items(), ("LDC2004S13", "LDC2005S13"),
                                              ("LDC2004T19", "LDC2005T19")):
        table = ["CALL_ID,DATE_TIME,TOPICID,SIG_GRADE,CNV_GRADE,APIN,ASX.DL,APHNUM,APHSET,"
                 "APHTYP,BPIN,BSX.DL,BPHNUM,BPHSET,BPHTYP"]
        for k, session in enumerate(sessions):
            seconds = 240.0 if session == "11487" else 4.0
            _fisher_call(root / a_dir, root / t_dir, part, session, seconds, 40 + k, rng,
                         "sph", TEL, "ulaw")
            table.append(f"{session},20041210_140000,ENG01,2.5,2.5,{60000 + int(session)},"
                         f"F.a,x,x,x,{70000 + int(session)},M.a,x,x,x")
        (root / t_dir / "doc").mkdir(parents=True)
        (root / t_dir / "doc" / f"fe_03_{part}_calldata.tbl").write_text("\n".join(table) + "\n")
        (root / t_dir / "doc" / "fe_03_readme.txt").write_text("not a transcript\n")
    return (root,), {}


TDF_HEADER = (
    "file;unicode\tchannel;int\tstart;float\tend;float\tspeaker;unicode\t"
    "speakerType;unicode\tspeakerDialect;unicode\ttranscript;unicode\t"
    "section;int\tturn;int\tsegment;int\tsectionType;unicode\tsuType;unicode\n"
    ";;MM sectionTypes\n;;MM sectionBoundaries\n")


def _tdf_row(reco, channel, start, end, speaker, text, dialect="dialect"):
    """tests/test_recipes_tranche3.py:_tdf_row."""
    return (f"{reco}\t{channel}\t{start}\t{end}\t{speaker}\tmale\t{dialect}\t{text}"
            f"\t0\t1\t2\treport\tstatement\n")


def _tdf15(rows):
    """tests/test_recipes_tranche15.py:_tdf: three junk header rows."""
    return "\n".join(["h1\th2", ";;junk", "more junk"] + rows) + "\n"


def _row15(reco, ch, start, end, spk, text):
    return "\t".join([f"{reco}.sph", str(ch), str(start), str(end), spk, "male", "MSA", text,
                      "1", "2", "3", "report", "statement"])


def fisher_spanish_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:263 (WAV bytes under
    ``.sph``); ``wide``: three sessions of two-channel 8 kHz mu-law SPHERE,
    TDF rows on both channels, a malformed row, a zero-length row and runs
    of spaces in the text."""
    adir, tdir = root / "audio", root / "trans"
    tdir.mkdir(parents=True)
    if layout == "tranche3":
        _audio(adir / "fsp_20050301_1.sph", 10.0, SR, seed=26, channels=2)
        (tdir / "fsp_20050301_1.tdf").write_text(
            TDF_HEADER + _tdf_row("fsp_20050301_1", 0, 0.5, 2.0, "x", "hola  amigo")
            + _tdf_row("fsp_20050301_1", 1, 2.0, 3.5, "y", "buenos dias"))
        (tdir / "spanish_call.tbl").write_text(
            "sid,junk,spkA,a,b,c,d,e,spkB\n1,z,maria,a,b,c,d,e,jose\n")
        return (adir, tdir), {}
    rng = np.random.RandomState(2010)
    table = ["sid,date,spkA,a,b,c,d,e,spkB"]
    for k, (date, sid) in enumerate((("20050301", "1"), ("20050302", "7"), ("20050310", "12"))):
        stem = f"fsp_{date}_{sid}"
        _audio(adir / date[:6] / f"{stem}.sph", 4.0, TEL, seed=50 + k, channels=2, fmt="sph",
               coding="ulaw")
        rows, t = [], 0.0
        for i in range(5):
            end = round(t + rng.uniform(0.3, 0.7), 3)
            rows.append(_tdf_row(f"{stem}.sph", i % 2, t, end, f"spk{i % 2}",
                                 "  hola   que tal  " if i == 2 else "buenos dias amigo"))
            t = end
        rows.append(_tdf_row(stem, 0, t, t, "spk0", "sin duracion"))
        rows.append("a\tmalformed\trow\n")
        (tdir / f"{stem}.tdf").write_text(TDF_HEADER + "".join(rows))
        table.append(f"{sid},{date},spk{sid}a,x,x,x,x,x,spk{sid}b")
    (tdir / "doc").mkdir()
    (tdir / "doc" / "fsp_call.tbl").write_text("\n".join(table) + "\n")
    return (adir, tdir), {}


def callhome_english_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:161 (WAV bytes under
    ``.sph``, a wrapped transcript row); ``refdiff``:
    tests/test_refdiff_recipes.py:2147 (16 kHz SPHERE); ``wide``: two
    conversations of two-channel 8 kHz mu-law SPHERE per split, with
    wrapped rows and a non-positive row; ``sre``: the diarization task, the
    audio with an SRE-2000 RTTM key (a zero-duration row)."""
    audio, trans = root / "audio", root / "trans"
    if layout == "sre":
        for k, rec in enumerate(("iaaa", "iaab")):
            _audio(audio / "data" / f"{rec}.sph", 6.0, TEL, seed=60 + k, channels=2, fmt="sph",
                   coding="ulaw")
        rttm = root / "sre2000-key"
        rttm.mkdir(parents=True)
        (rttm / "fullref.rttm").write_text(
            "SPEAKER iaaa 1 0.50 1.25 <NA> <NA> A <NA> <NA>\n"
            "SPEAKER iaaa 1 1.80 0.00 <NA> <NA> B <NA> <NA>\n"
            "SPEAKER iaaa 1 2.00 1.50 <NA> <NA> B <NA> <NA>\n"
            "SPEAKER iaab 1 0.10 2.20 <NA> <NA> A <NA> <NA>\n")
        return (audio,), {"rttm_dir": rttm}
    rng = np.random.RandomState(20)
    for split, adir in (("train", "train"), ("devtest", "devtest"), ("evaltest", "evltest")):
        tdir = trans / "transcrpt" / split
        tdir.mkdir(parents=True)
        if layout == "tranche3":
            _audio(audio / "data" / adir / f"en_{split}.sph", 30.0, SR, seed=20, channels=2)
            (tdir / f"en_{split}.txt").write_text(
                "# comment line\n1.00 2.50 A: hello there\n2.50 4.00 B: hi and this line\n"
                "wraps onto the next\n")
            continue
        if layout == "refdiff":
            _audio(audio / "data" / adir / f"en_{split}.sph", 0, SR, fmt="sph",
                   x=(0.1 * rng.randn(2, 30 * SR)).astype(np.float32))
            (tdir / f"en_{split}.txt").write_text(
                "# comment line\n1.00 2.50 A: hello there\n2.50 4.00 B: hi there\n")
            continue
        for k in range(2):
            conv = f"en_{4000 + 10 * k + len(split)}"
            _audio(audio / "data" / adir / f"{conv}.sph", 5.0, TEL, seed=70 + k, channels=2,
                   fmt="sph", coding="ulaw")
            rows, t = ["# CALLHOME American English", ""], 0.2
            for i in range(5):
                end = round(t + rng.uniform(0.3, 0.8), 2)
                rows.append(f"{t:.2f} {end:.2f} {'AB'[i % 2]}: {_words(rng)}")
                if i == 2:
                    rows.append(_words(rng))  # a wrapped row
                t = end
            rows.append(f"{t:.2f} {t:.2f} A: nothing")
            (tdir / f"{conv}.txt").write_text("\n".join(rows) + "\n")
    return (audio,), {"transcript_dir": trans}


def callhome_egyptian_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:184 (WAV bytes under
    ``.sph``); ``refdiff``: tests/test_refdiff_recipes.py:2392 (SPHERE, the
    eval audio in ``evltest``); ``wide``: two two-channel 8 kHz mu-law
    conversations per split."""
    audio, trans = root / "audio", root / "trans"
    roman = "callhome_arabic_trans_970711/transcrp/{}/roman"
    if layout == "tranche3":
        for split, adir, rid, text, seconds, seed in (
                ("train", "train", "ar_1", "0.50 2.00 B: %ah Tayyib\n", 10.0, 21),
                ("devtest", "devtest", "ar_2", "0.00 1.00 A: kalam\n", 5.0, 22),
                ("evaltest", "evltest", "ar_3", "0.00 1.00 A: kalam\n", 5.0, 23)):
            _audio(audio / "callhome/arabic" / adir / f"{rid}.sph", seconds, SR, seed=seed)
            (trans / roman.format(split)).mkdir(parents=True)
            (trans / roman.format(split) / f"{rid}.txt").write_text(text)
        return (audio, trans), {}
    rng = np.random.RandomState(45)
    for split, adir in (("train", "train"), ("devtest", "devtest"), ("evaltest", "evltest")):
        (trans / roman.format(split)).mkdir(parents=True)
        for k in range(1 if layout == "refdiff" else 2):
            rid = f"ar_{4000 + 10 * k + len(split)}"
            if layout == "refdiff":
                _audio(audio / "callhome" / "arabic" / adir / f"{rid}.sph", 10.0, SR,
                       seed=21 + len(split), fmt="sph")
                text = "0.50 2.00 B: %ah Tayyib\n"
            else:
                _audio(audio / "callhome" / "arabic" / adir / f"{rid}.sph", 5.0, TEL,
                       seed=80 + k, channels=2, fmt="sph", coding="ulaw")
                rows, t = ["", "     "], 0.1
                for i in range(5):
                    end = round(t + rng.uniform(0.3, 0.8), 2)
                    rows.append(f"{t:.2f} {end:.2f} {'AB'[i % 2]}: %ah Tayyib {i}")
                    t = end
                rows.append(f"{t:.2f} {t - 0.1:.2f} A: backwards")
                text = "\n".join(rows) + "\n"
            (trans / roman.format(split) / f"{rid}.txt").write_text(text)
    return (audio, trans), {}


def gale_arabic_tree(root, layout="tranche15"):
    """``tranche3``: tests/test_recipes_tranche3.py:219 (WAV bytes under
    ``.flac``, a 'no speaker' row); ``tranche15``:
    tests/test_recipes_tranche15.py:27 (malformed and zero-length rows);
    ``refdiff``: tests/test_refdiff_recipes.py:1094; ``wide``: two
    corpus pairs, WAV and FLAC at 16 kHz, a recording in both corpora
    (deduplicated by stem) and two test ids."""
    adir, tdir = root / "LDC_S", root / "LDC_T"
    tdir.mkdir(parents=True)
    test_id = "ALAM_WITHEVENT_ARB_20070116_205800"
    if layout == "tranche3":
        _audio(adir / f"{test_id}.wav", 30.0, SR, seed=24)
        _audio(adir / "OTHER_PROG_ARB_20070101_000000.flac", 30.0, SR, seed=25)
        (tdir / "x.tdf").write_text(
            TDF_HEADER + _tdf_row(f"{test_id}.sph", 0, 1.0, 2.0, "spk*1", "marhaba")
            + _tdf_row("OTHER_PROG_ARB_20070101_000000", 0, 0.0, 3.0, "no speaker", "x")
            + _tdf_row("OTHER_PROG_ARB_20070101_000000", 0, 3.0, 4.0, "spk2", "ahlan"))
        return ([adir], [tdir]), {}
    train_id = "SOMECHAN_NEWS_ARB_20070101_120000"
    if layout in ("tranche15", "refdiff"):
        rng = np.random.RandomState(0)
        for rid in (train_id, test_id):
            _audio(adir / f"{rid}.wav", 0, SR, x=(0.1 * rng.randn(1, 3 * SR)).astype(np.float32))
        rows = [_row15(train_id, 0, 0.5, 1.6, "spk1", "مرحبا")]
        if layout == "tranche15":
            rows += [_row15(train_id, 0, 1.6, 1.6, "spk1", "zero duration"),
                     _row15(train_id, 0, 2.0, 2.5, "no speaker", "x"), "short\trow"]
        rows.append(_row15(test_id, 0, 0.0, 1.0, "spk2", "السلام"))
        (tdir / "a.tdf").write_text(_tdf15(rows))
        return ([adir], [tdir]), {}
    rng = np.random.RandomState(2013)
    adirs, tdirs = [root / "LDC2013S02", root / "LDC2014S07"], [root / "LDC2013T17",
                                                                  root / "LDC2014T17"]
    progs = [(test_id, "ARABIYA_FROMIRAQ_ARB_20070216_175800"),
             ("ALJZ_TODHARV_ARB_20070110_165800", "DUBAI_TV_ARB_20070111_193000")]
    for k, (a, t, ids) in enumerate(zip(adirs, tdirs, progs)):
        t.mkdir(parents=True)
        rows = []
        for j, rid in enumerate(ids):
            fmt = "wav" if j == 0 else "flac"
            _audio(a / "data" / f"{rid}.{fmt}", 5.0, SR, seed=90 + 2 * k + j, fmt=fmt)
            t0 = 0.0
            for i in range(4):
                end = round(t0 + rng.uniform(0.4, 1.0), 3)
                rows.append(_tdf_row(f"{rid}.sph", 0, t0, end, f"spk*{i % 2}", "كلام عربي"))
                t0 = end
        (t / "data" / "tdf").mkdir(parents=True)
        (t / "data" / "tdf" / f"part{k}.tdf").write_text(TDF_HEADER + "".join(rows))
    # The first corpus's recording once more in the second: one recording per stem.
    _audio(adirs[1] / "data" / f"{test_id}.wav", 5.0, SR, seed=90)
    return (adirs, tdirs), {}


def gale_mandarin_tree(root, layout="tranche4"):
    """``tranche4``: tests/test_recipes_tranche4.py:234 (WAV bytes under
    ``.flac``), dev ids ``["CCTV_DEV_20070101"]``; ``refdiff``:
    tests/test_refdiff_recipes.py:2090, no dev ids; ``wide``: two corpus
    pairs of 16 kHz WAV and FLAC, a transcript row of a recording the audio
    lacks. Returns the arguments, the keyword arguments and the dev ids."""
    adir, tdir = root / "audio", root / "trans"
    tdir.mkdir(parents=True)
    if layout == "tranche4":
        _audio(adir / "CCTV_DEV_20070101.wav", 10.0, SR, seed=13)
        _audio(adir / "CCTV_TRAIN_20070102.flac", 10.0, SR, seed=14)
        (tdir / "x.tdf").write_text(
            TDF_HEADER + _tdf_row("CCTV_DEV_20070101", 0, 0.5, 2.0, "spkA", "你好")
            + _tdf_row("CCTV_TRAIN_20070102", 0, 1.0, 3.0, "spkB", "世界"))
        return ([adir], [tdir]), {}, ["CCTV_DEV_20070101"]
    if layout == "refdiff":
        _audio(adir / "CCTV_TRAIN_20070102.wav", 10.0, SR, seed=14)
        (tdir / "x.tdf").write_text(
            TDF_HEADER + "CCTV_TRAIN_20070102\t0\t1.0\t3.0\tspkB\tmale\tdialect\t世界\t0\t1\t2"
            "\treport\tstatement\n")
        return ([adir], [tdir]), {}, []
    rng = np.random.RandomState(2015)
    adirs, tdirs = [root / "LDC2013S08", root / "LDC2015S06"], [root / "LDC2013T20",
                                                                  root / "LDC2015T09"]
    ids = [("CCTV2_NEWS1_CMN_20060201_180000", "VOA_FOCUS_CMN_20080305_210000"),
           ("PHOENIX_BEHIND_CMN_20070601_143000", "CCTV4_DAILYNEWS_CMN_20070602_120000")]
    text = ("中国", "经济", "发展", "今天", "新闻", "世界", "我们", "记者", "报道")
    for k, (a, t, pair) in enumerate(zip(adirs, tdirs, ids)):
        t.mkdir(parents=True)
        rows = []
        for j, rid in enumerate(pair):
            _audio(a / f"{rid}.{'wav' if j == 0 else 'flac'}", 5.0, SR, seed=110 + 2 * k + j,
                   fmt="wav" if j == 0 else "flac")
            t0 = 0.0
            for i in range(4):
                end = round(t0 + rng.uniform(0.4, 1.0), 3)
                words = "".join(text[x] for x in rng.randint(0, len(text), 4))
                rows.append(_tdf_row(rid, 0, t0, end, f"spk{i % 2}", words))
                t0 = end
        rows.append(_tdf_row("NO_AUDIO_CMN_20070101_000000", 0, 0.0, 1.0, "spk0", "没有"))
        (t / f"part{k}.tdf").write_text(TDF_HEADER + "".join(rows))
    return (adirs, tdirs), {}, [ids[0][1], ids[1][0]]


def mgb2_tree(root, layout="full"):
    """``full``: the MGB-2 layout: dev and test as Kaldi directories
    (``text.non_overlap_speech`` in BuckWalter, ``segments.non_overlap_speech``,
    ``wav.scp`` with ``wav/`` paths) and train as 16 kHz WAV with one XML file
    per programme (segments above the WMER threshold, punctuation and
    diacritics in the text). The dev-only layout of
    tests/test_recipes_tranche3.py:341 is ``test_mgb2_dev_only_equals_jax``."""
    rng = np.random.RandomState(2)
    for k, part in enumerate(("dev", "test")):
        d = root / part
        texts, segments, scp = [], [], []
        for j in range(2):
            prog = f"prog{part}{j}"
            _audio(d / "wav" / f"{prog}.wav", 5.0, SR, seed=120 + 2 * k + j)
            for i in range(3):
                start = round(0.2 + 1.5 * i, 2)
                seg = f"{prog}-seg{i}"
                texts.append(f"{seg} mrHbA bkm fy {'AlErby' if i % 2 else 'Al>xbAr'}")
                segments.append(f"{seg} {prog} {start} {start + rng.uniform(0.5, 1.2):.2f}")
            scp.append(f"{prog} wav/{prog}.wav")
        (d / "text.non_overlap_speech").write_text("\n".join(texts) + "\n")
        (d / "segments.non_overlap_speech").write_text("\n".join(segments) + "\n")
        (d / "wav.scp").write_text("\n".join(scp) + "\n")
    words = ("مَرْحَبا", "بِكُم", "في", "الأخبار،", "اليوم!", "٢٠١٦", "و", "الطقس.")
    for j, prog in enumerate(("AlJazeera_Prog_A", "AlJazeera_Prog_B")):
        _audio(root / "train" / "wav" / f"{prog.replace('_', '-')}.wav", 6.0, SR, seed=130 + j)
        segs = []
        for i in range(4):
            start = round(0.3 + 1.4 * i, 2)
            text = "".join(f"<element>{words[x]}</element>" for x in rng.randint(0, 8, 4))
            segs.append(f'<segment id="{prog}_utt{i}" starttime="{start}" '
                        f'endtime="{start + 1.1:.2f}" WMER="{[10.0, 95.0, 0.0, 80.0][i]}" '
                        f'who="TRSspeaker{i % 2 + 1}overlap">{text}</segment>')
        xml = root / "train" / "xml" / "utf8" / f"{prog}.xml"
        xml.parent.mkdir(parents=True, exist_ok=True)
        xml.write_text('<?xml version="1.0" encoding="utf-8"?><transcript><head/><body>'
                       '<segments annotation_id="x">' + "".join(segs)
                       + "</segments></body></transcript>", encoding="utf-8")
    return (root,), {}


def broadcast_news_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:319 (WAV bytes under
    ``.sph``); ``refdiff``: tests/test_refdiff_recipes.py:2120 (16 kHz
    SPHERE); ``wide``: two programmes of 16 kHz PCM SPHERE with several
    sections and turns, ``<overlap>`` markup, a turn without time marks, a
    filler section and a latin-1 transcript."""
    audio, trans = root / "audio", root / "trans"
    trans.mkdir(parents=True)
    if layout != "wide":
        _audio(audio / "prog1.sph", 30.0, SR, seed=33, fmt="wav" if layout == "tranche3" else "sph")
        (trans / "prog1.sgml").write_text(
            '<episode program="NPR News" language="English">\n'
            '<section type="report" starttime="0.0" endtime="10.0">\n'
            '<turn speaker="Alice Smith" spkrtype="female" starttime="0.0" endtime="10.0">\n'
            '<time sec="0.5">\nfirst segment text\n<time sec="4.0">\nsecond segment text\n'
            "</turn>\n</section>\n</episode>\n")
        return (audio, trans), {}
    for k, (stem, program) in enumerate((("e960521a", "CNN Early Prime"),
                                         ("h960529", "NPR All Things Considered"))):
        _audio(audio / f"{stem}.sph", 12.0, SR, seed=140 + k, fmt="sph")
        sgml = [f'<episode filename={stem} program="{program}" language=english version=1 '
                'version_date=970617>',
                "<section type=filler startTime=0.000 endTime=1.000>", "</section>",
                '<section type=report startTime=1.000 endTime=12.000 topic="news">',
                "<turn speaker=Linda_Wertheimer spkrtype=female startTime=1.000 endTime=6.500>",
                "<time sec=1.000>", "Good evening &amp; welcome", "<time sec=3.200>",
                "<overlap startTime=3.200 endTime=3.900>", "yes", "</overlap>",
                "the news tonight", "</turn>",
                "<turn speaker=unknown spkrtype=male startTime=6.500 endTime=7.000>", "</turn>",
                "<turn speaker=Noah_Adams spkrtype=male startTime=7.000 endTime=12.000>",
                "<time sec=7.000>", "thanks Linda", "<time sec=9.500>", "", "<time sec=10.000>",
                "caf\xe9 au lait", "</turn>", "</section>", "</episode>"]
        text = "\n".join(sgml) + "\n"
        (trans / f"{stem}.sgml").write_bytes(text.encode("latin-1" if k else "utf-8"))
    return (audio, trans), {}


# -- every recipe against JAX ---------------------------------------------------------------

TREES = {"switchboard": switchboard_tree, "eval2000": eval2000_tree,
         "fisher_english": fisher_english_tree, "fisher_spanish": fisher_spanish_tree,
         "callhome_english": callhome_english_tree, "callhome_egyptian": callhome_egyptian_tree,
         "gale_arabic": gale_arabic_tree, "gale_mandarin": gale_mandarin_tree,
         "mgb2": mgb2_tree, "broadcast_news": broadcast_news_tree}
P = {"switchboard": pswbd.prepare_switchboard, "eval2000": peval2000.prepare_eval2000,
     "fisher_english": pfisher.prepare_fisher_english,
     "fisher_spanish": pfsp.prepare_fisher_spanish,
     "callhome_english": pchen.prepare_callhome_english,
     "callhome_egyptian": pche.prepare_callhome_egyptian,
     "gale_arabic": pgale_ar.prepare_gale_arabic, "gale_mandarin": pgale_zh.prepare_gale_mandarin,
     "mgb2": pmgb2.prepare_mgb2, "broadcast_news": pbn.prepare_broadcast_news}
JP = {"switchboard": jswbd.prepare_switchboard, "eval2000": jeval2000.prepare_eval2000,
      "fisher_english": jfisher.prepare_fisher_english,
      "fisher_spanish": jfsp.prepare_fisher_spanish,
      "callhome_english": jchen.prepare_callhome_english,
      "callhome_egyptian": jche.prepare_callhome_egyptian,
      "gale_arabic": jgale_ar.prepare_gale_arabic,
      "gale_mandarin": jgale_zh.prepare_gale_mandarin,
      "mgb2": jmgb2.prepare_mgb2, "broadcast_news": jbn.prepare_broadcast_news}

# case: (recipe, layout, extra keyword arguments of both prepare_* calls)
CASES = {
    "switchboard-recipes": ("switchboard", "recipes", {}),
    "switchboard-recipes-retain": ("switchboard", "recipes", {"omit_silence": False}),
    "switchboard-tranche12": ("switchboard", "tranche12", {}),
    "switchboard-tranche12-retain": ("switchboard", "tranche12", {"omit_silence": False}),
    "switchboard-refdiff": ("switchboard", "refdiff", {}),
    "switchboard-wide": ("switchboard", "wide", {}),
    "eval2000-recipes": ("eval2000", "recipes", {}),
    "eval2000-refdiff": ("eval2000", "refdiff", {}),
    "eval2000-wide": ("eval2000", "wide", {}),
    "fisher_english-tranche2": ("fisher_english", "tranche2", {}),
    "fisher_english-refdiff": ("fisher_english", "refdiff", {}),
    "fisher_english-wide": ("fisher_english", "wide", {}),
    "fisher_spanish-tranche3": ("fisher_spanish", "tranche3", {}),
    "fisher_spanish-wide": ("fisher_spanish", "wide", {}),
    "callhome_english-tranche3": ("callhome_english", "tranche3", {}),
    "callhome_english-refdiff": ("callhome_english", "refdiff", {}),
    "callhome_english-wide": ("callhome_english", "wide", {"absolute_paths": True}),
    "callhome_english-sre": ("callhome_english", "sre", {}),
    "callhome_egyptian-tranche3": ("callhome_egyptian", "tranche3", {}),
    "callhome_egyptian-refdiff": ("callhome_egyptian", "refdiff", {}),
    "callhome_egyptian-wide": ("callhome_egyptian", "wide", {}),
    "gale_arabic-tranche3": ("gale_arabic", "tranche3", {}),
    "gale_arabic-tranche15": ("gale_arabic", "tranche15", {}),
    "gale_arabic-refdiff": ("gale_arabic", "refdiff", {}),
    "gale_arabic-wide": ("gale_arabic", "wide", {"absolute_paths": False}),
    "gale_mandarin-tranche4": ("gale_mandarin", "tranche4", {}),
    "gale_mandarin-refdiff": ("gale_mandarin", "refdiff", {}),
    "gale_mandarin-wide": ("gale_mandarin", "wide", {"absolute_paths": False}),
    "mgb2-full": ("mgb2", "full", {}),
    "mgb2-full-raw": ("mgb2", "full", {"text_cleaning": False, "buck_walter": True,
                                       "mer_thresh": 90, "num_jobs": 2}),
    "broadcast_news-tranche3": ("broadcast_news", "tranche3", {}),
    "broadcast_news-refdiff": ("broadcast_news", "refdiff", {}),
    "broadcast_news-wide": ("broadcast_news", "wide", {"absolute_paths": True}),
}


def _files(directory) -> dict:
    """Every file under ``directory`` by its relative path, ``.gz`` files
    decompressed (a gzip header carries its write time), with the
    directory's own path replaced."""
    out = {}
    for p in sorted(directory.rglob("*")):
        if p.is_file():
            data = gzip.decompress(p.read_bytes()) if p.suffix == ".gz" else p.read_bytes()
            out[str(p.relative_to(directory))] = data.replace(str(directory).encode(), b"<out>")
    return out


def _layout(tmp_path, recipe, layout, monkeypatch):
    """The layout's arguments; for GALE Mandarin, its dev ids in place of
    ``_fetch_dev_ids`` in both packages."""
    made = TREES[recipe](tmp_path / "corpus", layout)
    if recipe == "gale_mandarin":
        args, kwargs, dev_ids = made
        for module in (pgale_zh, jgale_zh):
            monkeypatch.setattr(module, "_fetch_dev_ids", lambda: list(dev_ids))
        return args, kwargs
    return made


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_equals_jax(tmp_path, monkeypatch, case):
    """The returned manifests and every file that each package's
    ``prepare_*`` writes on the same layout are equal."""
    recipe, layout, extra = CASES[case]
    args, kwargs = _layout(tmp_path, recipe, layout, monkeypatch)
    kwargs = {**kwargs, **extra}
    ours = P[recipe](*args, output_dir=tmp_path / "ours", **kwargs)
    theirs = JP[recipe](*args, output_dir=tmp_path / "jax", **kwargs)
    assert _dicts(ours) == _dicts(theirs)
    written = _files(tmp_path / "ours")
    assert written and written == _files(tmp_path / "jax")
    assert sum(len(v) for v in _sups_of(ours)) > 0


def _sups_of(made):
    """Every supervision set a recipe returned, at any depth."""
    if isinstance(made, dict):
        if "supervisions" in made or "segments" in made:
            return [made.get("supervisions", made.get("segments"))]
        return [s for v in made.values() for s in _sups_of(v)]
    return []


def _sorted(sups, key=lambda s: s.id):
    return sorted(sups, key=key)


def test_prepared_fields_as_the_jax_tests_expect(tmp_path, monkeypatch):
    """The JAX tests' assertions, on the port's manifests."""
    args, kw = switchboard_tree(tmp_path / "swbd", "tranche12")
    made = P["switchboard"](*args, **kw)
    sups = {s.id: s for s in made["supervisions"]}
    assert sorted(sups) == ["sw2001A-ms98-a-0001", "sw2001A-ms98-a-0003", "sw2001B-ms98-a-0001"]
    a, b = sups["sw2001A-ms98-a-0001"], sups["sw2001B-ms98-a-0001"]
    assert (a.channel, a.speaker, a.text) == (0, "sw02001A", "hello there")
    assert (b.channel, b.speaker, b.start, b.duration) == (1, "sw02001B", 0.5, 1.7)
    rec = made["recordings"]["sw02001"]
    assert rec.num_channels == 2
    np.testing.assert_allclose(rec.load_audio(), _signal(4, TEL, 0, channels=2),
                               atol=2 / 32768)
    assert len(P["switchboard"](*args, **{**kw, "omit_silence": False})["supervisions"]) == 4

    args, kw = eval2000_tree(tmp_path / "e2k", "refdiff")
    s0, s1 = _sorted(P["eval2000"](*args, **kw)["supervisions"])
    assert (s0.text, s0.channel, s1.channel, s1.speaker) == ("yeah right", 0, 1, "en_4156-B")

    args, kw = fisher_english_tree(tmp_path / "fe", "tranche2")
    made = P["fisher_english"](*args, output_dir=tmp_path / "fe_out", **kw)
    s0, s1 = _sorted(made["supervisions"], key=lambda s: s.start)
    assert (s0.channel, s0.speaker, s1.channel, s1.speaker) == (0, "9001", 1, "9002")

    args, kw = fisher_spanish_tree(tmp_path / "fsp")
    s0, s1 = _sorted(P["fisher_spanish"](*args, **kw)["supervisions"], key=lambda s: s.start)
    assert (s0.speaker, s1.speaker, s0.text, s0.language) == ("maria", "jose", "hola amigo",
                                                              "Spanish")

    args, kw = callhome_english_tree(tmp_path / "che")
    made = P["callhome_english"](*args, output_dir=tmp_path / "che_out", **kw)
    s0, s1 = _sorted(made["train"]["supervisions"], key=lambda s: s.start)
    assert (s0.channel, s1.channel) == (0, 1) and s1.text.endswith("wraps onto the next")
    assert "evaltest" in made

    args, kw = callhome_egyptian_tree(tmp_path / "chg")
    made = P["callhome_egyptian"](*args, output_dir=tmp_path / "chg_out", **kw)
    (sup,) = made["train"]["supervisions"]
    assert (sup.text, sup.speaker) == ("%ah Tayyib", "ar_1_B")
    assert len(made["evaltest"]["recordings"]) == 1

    args, kw = gale_arabic_tree(tmp_path / "ga", "tranche3")
    made = P["gale_arabic"](*args, output_dir=tmp_path / "ga_out", **kw)
    (test_sup,), (train_sup,) = made["test"]["supervisions"], made["train"]["supervisions"]
    assert (test_sup.speaker, test_sup.recording_id) == ("spk1",
                                                         "ALAM_WITHEVENT_ARB_20070116_205800")
    assert train_sup.custom["section_type"] == "report"

    args, kw, dev_ids = gale_mandarin_tree(tmp_path / "gm")
    monkeypatch.setattr(pgale_zh, "_fetch_dev_ids", lambda: dev_ids)
    made = P["gale_mandarin"](*args, output_dir=tmp_path / "gm_out", **kw)
    (dev,), (train,) = made["dev"]["supervisions"], made["train"]["supervisions"]
    assert dev.recording_id == "CCTV_DEV_20070101" and train.language == "Mandarin"

    args, kw = broadcast_news_tree(tmp_path / "bn")
    made = P["broadcast_news"](*args, output_dir=tmp_path / "bn_out", **kw)
    (section,) = made["sections"]
    s0, s1 = _sorted(made["segments"], key=lambda s: s.start)
    assert section.custom["program"] == "NPR News" and s0.text == "first segment text"
    assert (s0.start, s0.end, s1.end) == (0.5, 4.0, 10.0)
    assert (s0.speaker, s0.gender) == ("Alice Smith", "female")


def test_mgb2_dev_only_equals_jax(tmp_path):
    """tests/test_recipes_tranche3.py:341: dev as a Kaldi directory, train
    and test "prepared" by empty cached manifests in each output directory."""
    corpus = tmp_path / "corpus"
    dev = corpus / "dev"
    _audio(dev / "wav" / "prog1.wav", 10.0, SR, seed=27)
    (dev / "text.non_overlap_speech").write_text("prog1-seg1 mrHbA\n")
    (dev / "segments.non_overlap_speech").write_text("prog1-seg1 prog1 0.5 2.0\n")
    (dev / "wav.scp").write_text("prog1 wav/prog1.wav\n")
    made = {}
    for pkg, prepare in (("ours", P["mgb2"]), ("jax", JP["mgb2"])):
        out = tmp_path / pkg
        out.mkdir()
        for part in ("train", "test"):
            for kind in ("recordings", "supervisions"):
                with gzip.open(out / f"mgb2_{kind}_{part}.jsonl.gz", "wt") as f:
                    f.write("")
        made[pkg] = prepare(corpus, out, text_cleaning=False)
    assert _dicts(made["ours"]) == _dicts(made["jax"])
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")
    (sup,) = made["ours"]["dev"]["supervisions"]
    assert sup.text == pmgb2.from_buck_walter("mrHbA") == jmgb2.from_buck_walter("mrHbA")


@pytest.mark.parametrize("num_jobs", [1, 2])
def test_fisher_english_is_the_same_at_any_num_jobs(tmp_path, num_jobs):
    """The process pool's recordings and the thread pool's supervisions are
    taken in submission order: the manifests are JAX's at 1 job and at 2."""
    args, _ = fisher_english_tree(tmp_path / "corpus", "wide")
    ours = P["fisher_english"](*args, output_dir=tmp_path / "ours", num_jobs=num_jobs)
    theirs = JP["fisher_english"](*args, output_dir=tmp_path / "jax", num_jobs=1)
    assert _dicts(ours) == _dicts(theirs)
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")
    assert len(ours["recordings"]) == 4
    typo = [s for s in ours["supervisions"] if s.text == "known typo"]
    assert [(s.start, s.duration) for s in typo] == [(231.09, 2.97)]


def test_a_second_fisher_english_run_reads_its_cached_manifests_as_jax(tmp_path):
    args, _ = fisher_english_tree(tmp_path / "corpus", "wide")
    first = P["fisher_english"](*args, output_dir=tmp_path / "ours")
    JP["fisher_english"](*args, output_dir=tmp_path / "jax")
    for sph in list((tmp_path / "corpus").rglob("*.sph")):
        sph.write_bytes(b"")  # the audio goes bad: the cached recordings are read instead
    again = P["fisher_english"](*args, output_dir=tmp_path / "ours")
    assert _dicts(again) == _dicts(first) == _dicts(
        JP["fisher_english"](*args, output_dir=tmp_path / "jax"))


@pytest.mark.skipif(not putils.is_module_available("jieba"),
                    reason="GALE Mandarin's segment_words needs jieba")
@pytest.mark.parametrize("layout", ["tranche4", "wide"])
def test_gale_mandarin_segment_words_equals_jax(tmp_path, monkeypatch, layout):
    args, kwargs = _layout(tmp_path, "gale_mandarin", layout, monkeypatch)
    ours = P["gale_mandarin"](*args, output_dir=tmp_path / "ours", segment_words=True, **kwargs)
    theirs = JP["gale_mandarin"](*args, output_dir=tmp_path / "jax", segment_words=True,
                                 **kwargs)
    assert _dicts(ours) == _dicts(theirs)
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")
    texts = [s.text for part in ours.values() for s in part["supervisions"]]
    assert texts and all(" " in t for t in texts if len(t) > 2)


# -- refusals ---------------------------------------------------------------------------------


def _fisher_missing_audio(root):
    args, kw = fisher_english_tree(root, "wide")
    next(root.rglob("fe_03_00002.sph")).unlink()
    return args, kw


def _fisher_spanish_missing_session(root):
    args, kw = fisher_spanish_tree(root, "wide")
    table = next(root.rglob("*_call.tbl"))
    table.write_text("\n".join(table.read_text().splitlines()[:-1]) + "\n")
    return args, kw


def _eval2000_audio_only(root):
    (root / "LDC2002S09" / "hub5e_00" / "english").mkdir(parents=True)
    return (root,), {}


REFUSALS = {
    "switchboard-no-such-dir": lambda r: ((r / "none",), {"transcripts_dir": r}),
    "switchboard-no-transcripts": lambda r: ((switchboard_tree(r)[0][0],),
                                             {"transcripts_dir": r / "corpus"}),
    "eval2000-no-audio": lambda r: ((r,), {}),
    "eval2000-no-transcripts": _eval2000_audio_only,
    "fisher_english-no-corpus": lambda r: ((r,), {}),
    "fisher_english-missing-audio": _fisher_missing_audio,
    "fisher_spanish-missing-session": _fisher_spanish_missing_session,
    "callhome_english-no-split": lambda r: ((r,), {"transcript_dir": r}),
    "callhome_egyptian-no-split": lambda r: ((r, r), {}),
    "gale_arabic-unpaired": lambda r: (([r], []), {}),
    "gale_arabic-no-transcripts": lambda r: (([r], [r]), {}),
    "gale_mandarin-unpaired": lambda r: (([r], []), {}),
    "mgb2-no-such-dir": lambda r: ((r / "none",), {}),
    "broadcast_news-no-audio": lambda r: ((r, r), {}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refuses_as_jax(tmp_path, case):
    """Each package raises the same error with the same message."""
    recipe = case.split("-")[0]
    root = tmp_path / "corpus"
    root.mkdir()
    args, kwargs = REFUSALS[case](root)
    if recipe in ("fisher_english", "mgb2"):
        kwargs = {**kwargs, "output_dir": tmp_path / "out"}
    errors = []
    for prepare in (P[recipe], JP[recipe]):
        with pytest.raises(Exception) as info:
            prepare(*args, **kwargs)
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


def test_downloads_that_the_port_leaves_out_raise_before_any_network(tmp_path):
    """Where JAX's recipe downloads a missing input (the Switchboard
    transcripts, the SRE-2000 key), the port's raises ``NotImplementedError``
    and writes nothing."""
    args, _ = switchboard_tree(tmp_path / "swbd", "tranche12")
    with pytest.raises(NotImplementedError, match="download_and_untar"):
        P["switchboard"](*args, output_dir=tmp_path / "out")
    args, _ = callhome_english_tree(tmp_path / "che", "sre")
    with pytest.raises(NotImplementedError, match="download_callhome_metadata"):
        P["callhome_english"](*args, output_dir=tmp_path / "out")
    assert not (tmp_path / "out").exists()
    assert not hasattr(pswbd, "download_and_untar") and not hasattr(pmgb2, "download_mgb2")
    assert not hasattr(pchen, "download_callhome_metadata")


def _shorten_sphere(path, channels=2, frames=8000):
    """A SPHERE header as Switchboard-1 ships it (mu-law, embedded shorten)
    over bytes that are not decoded."""
    lines = ["database_id -s7 swb1_d1", "conversation_id -s4 2001",
             f"channel_count -i {channels}", f"sample_count -i {frames}",
             "sample_rate -i 8000", "sample_n_bytes -i 1", "sample_byte_format -s1 1",
             "sample_coding -s26 ulaw,embedded-shorten-v2.00", "end_head"]
    header = b"NIST_1A\n   1024\n" + "\n".join(lines).encode() + b"\n"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(header + b"\x00" * (1024 - len(header)) + bytes(range(256)) * 16)
    return path


def test_shorten_coded_sphere_raises_in_both_packages(tmp_path):
    """Neither package decodes embedded shorten without ``sph2pipe``: the
    probe reads the header in each, and reading the samples raises the same
    kind of error in each."""
    from lhotse_tpu_torch.audio import Recording

    path = _shorten_sphere(tmp_path / "sw02001.sph")
    ours, theirs = Recording.from_file(path), J.Recording.from_file(path)
    assert ours.to_dict() == theirs.to_dict()
    assert (ours.num_channels, ours.sampling_rate, ours.num_samples) == (2, 8000, 8000)
    errors = []
    for rec in (ours, theirs):
        with pytest.raises(Exception) as info:
            rec.load_audio()
        errors.append(type(info.value).__name__)
    assert errors[0] == errors[1]


# -- the helpers ------------------------------------------------------------------------------


def test_check_and_rglob_equals_jax(tmp_path):
    from lhotse_tpu.utils import check_and_rglob as jcheck

    for rel in ("a/x.sph", "a/b/y.sph", "c/z.SPH", "w.wav"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    for pattern in ("*.sph", "*.wav", "*"):
        assert putils.check_and_rglob(tmp_path, pattern) == jcheck(tmp_path, pattern)
    assert putils.check_and_rglob(tmp_path, "*.flac", strict=False) == [] == jcheck(
        tmp_path, "*.flac", strict=False)
    for args in ((tmp_path, "*.flac"), (tmp_path / "none", "*.sph"),
                 (tmp_path / "w.wav", "*")):
        errors = []
        for check in (putils.check_and_rglob, jcheck):
            with pytest.raises(AssertionError) as info:
                check(*args)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


def test_recursion_limit_sets_and_restores_as_jax():
    from lhotse_tpu.utils import recursion_limit as jlimit

    before = sys.getrecursionlimit()
    for limit in (putils.recursion_limit, jlimit):
        with limit(before + 4321):
            assert sys.getrecursionlimit() == before + 4321
        assert sys.getrecursionlimit() == before
        with pytest.raises(KeyError):
            with limit(5000):
                raise KeyError("inside")
        assert sys.getrecursionlimit() == before


TDF_FILE = (TDF_HEADER
            + _tdf_row("REC_A.sph", 0, 0.5, 1.5, " spk*1 ", "  مرحبا  ")
            + _tdf_row("REC_A", 1, 1.5, 2.5, "spk2", "ahlan")
            + _tdf_row("REC_A", 0, 2.5, 2.5, "spk1", "zero length")
            + _tdf_row("REC_A", 0, 3.0, 4.0, "no speaker", "music")
            + "REC_A\tx\t3.0\t4.0\tspk1\tmale\tMSA\tbad channel\t0\t1\t2\treport\tstatement\n"
            + "REC_A\t0\t3.0\n"
            + "\n"
            + _tdf_row("REC_B", 0, 0.0, 1.25, "spk3", "   ")
            + _tdf_row("REC_A.sph", 0, 0.5, 1.5, "spk*1", "duplicate id, later index"))


def test_tdf_parsers_equal_jax(tmp_path):
    """``iter_tdf_rows`` and ``tdf_supervisions``, with the rows that each
    skips: short, non-numeric, blank, 'no speaker', zero-length, and an id
    already seen (the same file twice)."""
    path = tmp_path / "x.tdf"
    path.write_text(TDF_FILE, encoding="utf-8")
    (tmp_path / "latin.tdf").write_bytes(TDF_FILE.encode("utf-8")[:-40] + b"\xe9\xff\n")
    for p in (path, tmp_path / "latin.tdf"):
        assert list(ptdf.iter_tdf_rows(p)) == list(jtdf.iter_tdf_rows(p))
    rows = list(ptdf.iter_tdf_rows(path))
    assert [r["channel"] for r in rows] == [0, 1, 0, 0, 0, 0]
    assert rows[0]["reco_id"] == "REC_A" and rows[0]["speaker"] == "spk1"
    assert ptdf.TDF_COLUMNS == jtdf.TDF_COLUMNS
    for transform in (None, str.upper):
        ours = ptdf.tdf_supervisions([path, path], "Arabic", transform_text=transform)
        theirs = jtdf.tdf_supervisions([path, path], "Arabic", transform_text=transform)
        assert [s.to_dict() for s in ours] == [s.to_dict() for s in theirs]
    # The ids carry the row's index among the rows kept: the second pass of
    # the same file repeats them all.
    assert [s.id for s in ours] == ["REC_A-spk1-0", "REC_A-spk2-1", "REC_B-spk3-4",
                                    "REC_A-spk1-5"]


CLEANED = ["مَرْحَبا ب العالم!!", "أهلاً وسهلاً", "abc 123", "٢٠١٦ ، الأخبار؟ «اليوم»",
           "ڤيديو_جديد | x  . y", "  "]
BUCKWALTER = ["mrHbA", "Al>xbAr", "{lEAlm", "qAl: \"ybdw\"", ""]


@pytest.mark.parametrize("text", CLEANED)
def test_mgb2_cleaning_equals_jax(text):
    assert pmgb2.cleaning(text) == jmgb2.cleaning(text)
    for step in ("remove_punctuations", "east_to_west_num", "remove_diacritics",
                 "remove_non_alphanumeric", "remove_single_char_word", "remove_extra_space"):
        assert getattr(pmgb2, step)(text) == getattr(jmgb2, step)(text)


@pytest.mark.parametrize("text", BUCKWALTER)
def test_mgb2_buckwalter_equals_jax(text):
    assert pmgb2.from_buck_walter(text) == jmgb2.from_buck_walter(text)


def test_mgb2_xml_supervisions_equal_jax(tmp_path):
    """tests/test_refdiff_recipes.py:2417's XML, at two WMER thresholds."""
    xml = tmp_path / "p.xml"
    xml.write_text(
        '<?xml version="1.0"?><transcript><segments annotation_id="x">'
        '<segment id="PROG_utt1" starttime="1.0" endtime="2.5" WMER="10.0" '
        'who="TRSspeaker3overlap"><element>ahlan</element><element>bik</element></segment>'
        '<segment id="PROG_utt2" starttime="3.0" endtime="4.0" WMER="95.0" '
        'who="TRSspeaker4overlap"><element>dropped</element></segment>'
        "</segments></transcript>")
    for thresh in (80, 100):
        ours = pmgb2.make_supervisions(xml, mer_thresh=thresh)
        assert [s.to_dict() for s in ours] == [
            s.to_dict() for s in jmgb2.make_supervisions(xml, mer_thresh=thresh)]
    (sup,) = pmgb2.make_supervisions(xml, mer_thresh=80)
    assert (sup.text, sup.speaker, sup.recording_id) == ("ahlan bik", 3, "PROG")
    assert pmgb2.cleaning("مَرْحَبا ب العالم!!") == "مرحبا العالم"


def test_callhome_readers_equal_jax(tmp_path):
    _, kw = callhome_english_tree(tmp_path / "sre", "sre")
    rttm = kw["rttm_dir"] / "fullref.rttm"
    assert [s.to_dict() for s in pchen.read_rttm(rttm)] == [
        s.to_dict() for s in jchen.read_rttm(rttm)]
    lines = ["# a comment", "", "1.00 2.50 A: hello", "continued here", "3.0 2.0 B: backwards",
             "not a row", "4.00 5.25 B1: %um yes", "x y z"]
    assert pchen._stitch_continuations(lines) == jchen._stitch_continuations(lines)
    path = tmp_path / "en_1234.txt"
    path.write_text("\n".join(lines) + "\n")
    for channel_from_speaker in (True, False):
        assert [s.to_dict() for s in pchen._parse_transcript(path, channel_from_speaker)] == [
            s.to_dict() for s in jchen._parse_transcript(path, channel_from_speaker)]


def test_fisher_english_typo_fix_equals_jax():
    rows = [[31.09, 234.06, "A", "x"], [31.09, 32.0, "B", "y"], [1.0, 2.0, "A", "z"]]
    for session in ("11487", "00001"):
        assert pfisher._fix_known_typos(session, rows) == jfisher._fix_known_typos(session, rows)
    assert pfisher._fix_known_typos("11487", rows)[0][0] == 231.09


def test_broadcast_news_sgml_equals_jax(tmp_path):
    args, _ = broadcast_news_tree(tmp_path / "bn", "wide")
    from lhotse_tpu_torch.audio import Recording

    for sgml, sph in zip(sorted(args[1].glob("*.sgml")), sorted(args[0].glob("*.sph"))):
        ours = pbn.make_supervisions(sgml, Recording.from_file(sph))
        theirs = jbn.make_supervisions(sgml, J.Recording.from_file(sph))
        assert {k: [s.to_dict() for s in v] for k, v in ours.items()} == {
            k: [s.to_dict() for s in v] for k, v in theirs.items()}
        assert len(ours["sections"]) == 2 and len(ours["segments"]) == 4
    assert pbn.EXCLUDE_BEGINNINGS == jbn.EXCLUDE_BEGINNINGS


# -- the prepare commands ---------------------------------------------------------------------

# (the command's arguments, "{out}" for the output directory; the layout; the port's call)
COMMANDS = {
    "switchboard": (lambda a, k: ["switchboard", a[0], "{out}", "--transcript-dir",
                                  k["transcripts_dir"], "--sentiment-dir", k["sentiment_dir"]],
                    lambda r: switchboard_tree(r, "wide"),
                    lambda a, k, o: P["switchboard"](*a, output_dir=o, **k)),
    "switchboard-retain": (lambda a, k: ["switchboard", a[0], "{out}", "--transcripts-dir",
                                         k["transcripts_dir"], "--retain-silence",
                                         "--absolute-paths"],
                           lambda r: switchboard_tree(r, "tranche12"),
                           lambda a, k, o: P["switchboard"](*a, output_dir=o, omit_silence=False,
                                                            **k)),
    "eval2000": (lambda a, k: ["eval2000", a[0], "{out}", "--transcript-dir",
                               k["transcript_path"]],
                 lambda r: eval2000_tree(r, "wide"),
                 lambda a, k, o: P["eval2000"](*a, output_dir=o, **k)),
    "fisher-english": (lambda a, k: ["fisher-english", a[0], "{out}", "-j", "2"],
                       lambda r: fisher_english_tree(r, "wide"),
                       lambda a, k, o: P["fisher_english"](*a, output_dir=o, **k)),
    "fisher-spanish": (lambda a, k: ["fisher-spanish", a[0], a[1], "{out}"],
                       lambda r: fisher_spanish_tree(r, "wide"),
                       lambda a, k, o: P["fisher_spanish"](*a, output_dir=o, **k)),
    "callhome-english": (lambda a, k: ["callhome-english", a[0], "{out}", "--transcript-dir",
                                       k["transcript_dir"], "--absolute-paths", "true"],
                         lambda r: callhome_english_tree(r, "wide"),
                         lambda a, k, o: P["callhome_english"](*a, output_dir=o,
                                                               absolute_paths=True, **k)),
    "callhome-english-sre": (lambda a, k: ["callhome-english", a[0], "{out}", "--rttm-dir",
                                           k["rttm_dir"]],
                             lambda r: callhome_english_tree(r, "sre"),
                             lambda a, k, o: P["callhome_english"](*a, output_dir=o, **k)),
    "callhome-egyptian": (lambda a, k: ["callhome-egyptian", a[0], a[1], "{out}"],
                          lambda r: callhome_egyptian_tree(r, "wide"),
                          lambda a, k, o: P["callhome_egyptian"](*a, output_dir=o, **k)),
    "gale-arabic": (lambda a, k: ["gale-arabic", "{out}", "-s", a[0][0], "-s", a[0][1], "-t",
                                  a[1][0], "-t", a[1][1]],
                    lambda r: gale_arabic_tree(r, "wide"),
                    lambda a, k, o: P["gale_arabic"](*a, output_dir=o, absolute_paths=False)),
    "gale-mandarin": (lambda a, k: ["gale-mandarin", "{out}", "-s", a[0][0], "-s", a[0][1],
                                    "-t", a[1][0], "-t", a[1][1]],
                      lambda r: gale_mandarin_tree(r, "wide"),
                      lambda a, k, o: P["gale_mandarin"](*a, output_dir=o,
                                                         absolute_paths=False)),
    "mgb2": (lambda a, k: ["mgb2", a[0], "{out}", "--no-text-cleaning", "--mer-thresh", "90"],
             lambda r: mgb2_tree(r, "full"),
             lambda a, k, o: P["mgb2"](*a, o, text_cleaning=False, mer_thresh=90)),
    "broadcast-news": (lambda a, k: ["broadcast-news", a[0], a[1], "{out}"],
                       lambda r: broadcast_news_tree(r, "wide"),
                       lambda a, k, o: P["broadcast_news"](*a, output_dir=o)),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_prepare_command_writes_what_its_function_writes(tmp_path, monkeypatch, name):
    """Each ``prepare`` command writes the files its function writes, and
    the JAX CLI's command the same, with the output directory replaced."""
    from test_torch_cli import _both as both_clis

    argv, build, function = COMMANDS[name]
    made = build(tmp_path / "corpus")
    args, kwargs = made[:2]
    if name == "gale-mandarin":
        for module in (pgale_zh, jgale_zh):
            monkeypatch.setattr(module, "_fetch_dev_ids", lambda: list(made[2]))
    runs = both_clis(tmp_path, "prepare", *argv(args, kwargs), seed=0)
    function(args, kwargs, tmp_path / "function")
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    ours = _files(pout)
    assert ours and ours == _files(tmp_path / "function") == _files(jout)


# -- the slice: Switchboard and Fisher English muxed into the on-device chain -----------------

MUX_SEED = 23


def _telephone_cuts(pkg, roots):
    """Each package's Switchboard and Fisher English layouts → ``prepare_*``
    → ``CutSet.from_manifests`` → ``trim_to_supervisions`` (each side of a
    call its own channel) → ``resample(16000)`` → ``CutSet.mux``, as a list."""
    if pkg == "port":
        CS, seed_fn, recipes = CutSet, fix_random_seed, P
    else:
        CS, seed_fn, recipes = J.CutSet, jfix, JP
    (sw_args, sw_kw), (fe_args, fe_kw) = roots
    made = [recipes["switchboard"](*sw_args, **sw_kw),
            recipes["fisher_english"](*fe_args, output_dir=fe_args[0] / f"manifests_{pkg}",
                                      **fe_kw)]
    seed_fn(0)
    sets = [CS.from_manifests(**m).trim_to_supervisions(keep_overlapping=False)
            .resample(16000).to_eager() for m in made]
    return list(CS.mux(*sets, weights=[1, 1], seed=MUX_SEED))


def _short_fisher(root):
    """Two calls of two-channel 8 kHz mu-law SPHERE (LDC2004S13/T19)."""
    rng = np.random.RandomState(2004)
    table = ["CALL_ID,DATE_TIME,TOPICID,SIG_GRADE,CNV_GRADE,APIN,ASX.DL,APHNUM,APHSET,APHTYP,"
             "BPIN,BSX.DL,BPHNUM,BPHSET,BPHTYP"]
    for k, session in enumerate(("00001", "00002")):
        stem = f"fe_03_{session}"
        _audio(root / "LDC2004S13" / "audio" / "000" / f"{stem}.sph", 4.0, TEL, seed=150 + k,
               channels=2, fmt="sph", coding="ulaw")
        rows = [f"{1.6 * i:.2f} {1.6 * i + 1.2 + 0.2 * k:.2f} {'AB'[i % 2]}: {_words(rng)}"
                for i in range(2)]
        tdir = root / "LDC2004T19" / "fe_03_p1_tran" / "data" / "trans" / "000"
        tdir.mkdir(parents=True, exist_ok=True)
        (tdir / f"{stem}.txt").write_text("#\n#\n\n" + "\n".join(rows) + "\n")
        table.append(f"{session},x,x,x,x,{5000 + k},x,x,x,x,{6000 + k},x,x,x,x")
    (root / "LDC2004T19" / "doc").mkdir(parents=True)
    (root / "LDC2004T19" / "doc" / "fe_03_p1_calldata.tbl").write_text("\n".join(table) + "\n")
    return (root,), {"audio_dirs": ["LDC2004S13"], "transcript_dirs": ["LDC2004T19"],
                     "absolute_paths": True}


def _short_switchboard(root):
    """Two conversations of two-channel 8 kHz mu-law SPHERE with MS-State
    transcripts, two turns on each side."""
    rng = np.random.RandomState(2001)
    trans = root / "swb_ms98_transcriptions"
    for k, conv in enumerate(("2001", "2005")):
        _audio(root / "swb1" / f"sw0{conv}.sph", 4.0, TEL, seed=160 + k, channels=2, fmt="sph",
               coding="ulaw")
        for side in "AB":
            rows = [f"sw{conv}{side}-ms98-a-{i + 1:04d} {1.9 * i:.2f} {1.9 * i + 1.3:.2f} "
                    f"{_words(rng)}" for i in range(2 - (side == "B" and k == 1))]
            (trans / conv[:2] / conv).mkdir(parents=True, exist_ok=True)
            (trans / conv[:2] / conv / f"sw{conv}{side}-ms98-a-trans.text").write_text(
                "\n".join(rows) + "\n")
    return (root / "swb1",), {"transcripts_dir": trans, "absolute_paths": True}


@pytest.fixture(scope="module")
def telephone_slice(tmp_path_factory):
    root = tmp_path_factory.mktemp("telephone_slice")
    roots = (_short_switchboard(root / "swbd"), _short_fisher(root / "fisher"))
    ours, theirs = _telephone_cuts("port", roots), _telephone_cuts("jax", roots)
    return root, ours, theirs


TELEPHONE_TOL = 1e-3  # above 4 kHz, from the same stages in float64: measured 6.3e-4 and 5.2e-4


def _telephone_band() -> np.ndarray:
    """The mel bins of the port's fbank layer that take no power from 4 kHz
    up: the band that 8 kHz audio fills."""
    from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank

    fb = np.asarray(Wav2LogFilterBank(device="cpu")._fused_matrices()[2])
    return fb[fb.shape[0] // 2:].max(axis=0) == 0


def test_telephone_mux_fed_augmenter_equals_jax(telephone_slice):
    """Seven Switchboard and four Fisher English sides, trimmed, resampled
    and muxed, in batches of the 2 s x 4 bucket through each package's
    augmenter. In the mel bins below 4 kHz the port is within ``AUG_TOL`` of
    the JAX augmenter whose fbank stage is its kernel route in float64. Above
    4 kHz the 8 kHz audio holds only the int16 wire's quantization floor (log
    mel -8 to -13) and the float32 audio stages' rounding (speed
    perturbation, noise, RIR) is amplified there: both chains are within
    ``TELEPHONE_TOL`` of the port's same stages in float64 (6.3e-4 and 5.2e-4
    on this mux), and 5.8e-4 apart."""
    from lhotse_tpu_torch.ops import augment, resample
    from test_torch_host_loader import _Float64Fbank, _Float64Torch

    root, ours, theirs = telephone_slice
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs] and len(ours) == 11
    assert {c.channel for c in ours} == {0, 1} and all(c.sampling_rate == SR for c in ours)
    corpora = ["swbd" if c.recording_id.startswith("sw") else "fisher" for c in ours]
    assert sorted(corpora) == ["fisher"] * 4 + ["swbd"] * 7
    assert len(set(corpora[:4])) > 1  # the first batch mixes the corpora
    musan, rirs = musan_tree(root / "musan", "pool"), rir_noise_tree(root / "RIRS", 2)
    pool = noise_pool(pmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"])
    rir = seeded_rir(prir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"])
    assert np.array_equal(
        pool, noise_pool(jmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"]))
    assert np.array_equal(
        rir, seeded_rir(jrir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"]))
    common = dict(speed_factor=1.1, noise_pool=pool, rir=rir, snr=(10, 20), mix_prob=0.5, seed=5,
                  wire_format="int16")
    port = OnDeviceAugmenter([(2.0, 4)], specaugment=SpecAugment(seed=7), device="cpu", **common)
    jax_aug = JAugmenter([(2.0, 4)], specaugment=JSpecAugment(seed=7), fbank=_JaxKernelRoute64(),
                         **common)
    plain = OnDeviceAugmenter([(2.0, 4)], device="cpu", fbank=_Float64Fbank(), **common)
    band = _telephone_band()
    assert band.sum() == 61  # mel bins 0-60
    batches = _bucketed(ours[:8])
    for (audio, lens), (jaudio, jlens) in zip(batches, _bucketed(theirs[:8])):
        assert np.array_equal(audio, jaudio) and np.array_equal(lens, jlens)
    mixed = 0
    for audio, lens in batches:
        s_ours, s_theirs = port.stage(audio, lens), jax_aug.stage(audio, lens)
        mixed += int(np.asarray(s_ours.kwargs["mix_mask"]).sum())
        feats, feat_lens = port.compute(s_ours)
        jfeats, jfeat_lens = jax_aug.compute(s_theirs)
        feats, jfeats = feats.numpy(), np.asarray(jfeats)
        assert feats.shape == jfeats.shape and feats.shape[0] == 4 and np.isfinite(feats).all()
        assert np.array_equal(feat_lens.numpy(), np.asarray(jfeat_lens))
        np.testing.assert_allclose(feats[..., band], jfeats[..., band], rtol=0, atol=AUG_TOL)
        # The same stages in float64 (SpecAugment's masks aside: it runs on the features).
        conv_weight = resample._conv_weight
        saved = augment.torch, resample.torch, resample._conv_weight
        augment.torch = resample.torch = _Float64Torch()
        resample._conv_weight = lambda *a: conv_weight(*a).double()
        try:
            truth, _ = plain.compute(s_ours)
        finally:
            augment.torch, resample.torch, resample._conv_weight = saved
        truth = truth.numpy()
        kept = (feats != 0) & (jfeats != 0)  # SpecAugment's masked cells are zero in both
        real = (np.arange(truth.shape[1])[None, :] < feat_lens.numpy()[:, None])[..., None] & kept
        for chain in (feats, jfeats):
            assert np.abs(chain - truth)[real].max() <= TELEPHONE_TOL
        assert np.abs(feats - truth)[real & band].max() <= AUG_TOL
    assert mixed > 0  # the MUSAN pool went into some rows


def test_telephone_mux_on_the_fly_equals_jax(telephone_slice, monkeypatch):
    """The same mux through ``K2SpeechRecognitionDataset`` with
    ``OnTheFlyFeatures``: within ``EXTRACTOR_TOL`` of the JAX extractor's
    host chain in float64, and in the mel bins below 4 kHz of its device
    route too. Above 4 kHz that route (XLA float32) is up to 8.5e-4 from
    float64 on this mux, where the port is within 1e-4."""
    _, ours, theirs = telephone_slice
    dataset = K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    # The JAX extractors' device route, in XLA on the CPU, and their host chain in float64.
    jdataset = JDataset(return_cuts=True,
                        input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))))
    j64 = JDataset(return_cuts=True, input_strategy=JOnTheFly(JFbank(JFbankConfig(device="cpu"))))
    monkeypatch.setenv("LHOTSE_TPU_HOST_FFT_DTYPE", "float64")
    band = _telephone_band()
    texts = []
    for i in range(0, len(ours), 4):
        a = dataset[CutSet.from_cuts(ours[i:i + 4])]
        b = jdataset[J.CutSet.from_cuts(theirs[i:i + 4])]
        c = j64[J.CutSet.from_cuts(theirs[i:i + 4])]
        x, y, z = (np.asarray(d["inputs"]) for d in (a, b, c))
        assert x.shape == y.shape == z.shape and np.isfinite(x).all()
        np.testing.assert_allclose(x, z, rtol=0, atol=EXTRACTOR_TOL)
        np.testing.assert_allclose(x[..., band], y[..., band], rtol=0, atol=EXTRACTOR_TOL)
        for key in ("sequence_idx", "start_frame", "num_frames"):
            np.testing.assert_array_equal(a["supervisions"][key], b["supervisions"][key])
        assert a["supervisions"]["text"] == b["supervisions"]["text"]
        texts += a["supervisions"]["text"]
    assert len(texts) == 11 and all(texts)
