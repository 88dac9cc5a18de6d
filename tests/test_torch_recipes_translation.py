"""
The port's speech-translation and multilingual corpus recipes
(lhotse_tpu_torch.recipes ``must_c``, ``iwslt22_ta``, ``mtedx``, ``gigast``,
``voxpopuli``, ``gigaspeech2``, ``emilia`` and ``bvcc``) against the JAX
package's, on the fixture layouts of tests/test_recipes_tranche3.py:721-900,
tests/test_recipes_tranche5.py:130, tests/test_recipes_tranche4.py:311,
tests/test_recipes_tranche2.py:429 and tests/test_refdiff_recipes.py:1579,
1666,1717,1747,2235,2333 (made from the same numpy seeds), and on wider
layouts of the same formats: MuST-C with several talks per split and with a
talk's rows not adjacent, IWSLT 2022 Tunisian Arabic as 8 kHz SPHERE with
duplicates, exclusions and a file without translations (``normalize_text``
on and off), mTEDx in two languages with noise spans, tags and invalid
characters, GigaST over two GigaSpeech parts in both languages, VoxPopuli
at 1 and 4 jobs, GigaSpeech 2 in two languages with missing audio, Emilia
over two metadata files and BVCC with several listeners per utterance.
Also their helpers, cached re-runs, their refusals of broken layouts, the
downloads they leave out, their ``prepare`` commands through both CLIs,
and the slice at a small size: MuST-C trimmed to its supervisions through
each package's ``OnDeviceAugmenter`` (within ``AUG_TOL`` of the JAX
augmenter with its fbank layer's kernel route in float64), and IWSLT 2022
Tunisian Arabic resampled to 16 kHz through
``K2Speech2TextTranslationDataset`` with ``OnTheFlyFeatures`` (within
``EXTRACTOR_TOL`` of the JAX extractor's host chain in float64). CSJ is in
tests/test_torch_recipes_csj.py.
"""
import gzip
import json
import logging

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac
from lhotse_tpu.audio.sphio import write_sph
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.dataset.speech_translation import K2Speech2TextTranslationDataset as JTranslation
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import bvcc as jbvcc
from lhotse_tpu.recipes import emilia as jemilia
from lhotse_tpu.recipes import gigaspeech2 as jgs2
from lhotse_tpu.recipes import gigast as jgigast
from lhotse_tpu.recipes import iwslt22_ta as jiwslt
from lhotse_tpu.recipes import mtedx as jmtedx
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import must_c as jmustc
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.recipes import voxpopuli as jvox
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.dataset.speech_translation import K2Speech2TextTranslationDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import bvcc as pbvcc
from lhotse_tpu_torch.recipes import emilia as pemilia
from lhotse_tpu_torch.recipes import gigaspeech2 as pgs2
from lhotse_tpu_torch.recipes import gigast as pgigast
from lhotse_tpu_torch.recipes import iwslt22_ta as piwslt
from lhotse_tpu_torch.recipes import mtedx as pmtedx
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import must_c as pmustc
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.recipes import voxpopuli as pvox
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_recipes_asr import _dicts
from test_torch_recipes_noise import (
    AUG_TOL, EXTRACTOR_TOL, musan_tree, noise_pool, rir_noise_tree, seeded_rir)
from test_torch_recipes_overlap import _files
from test_torch_recipes_zh import _JaxKernelRoute64, _bucketed

SR = 16000
GERMAN = ("Hallo", "Welt", "schön", "Grüße", "Straße", "wir", "müssen", "über", "Energie",
          "nachdenken", "und", "das", "Klima")
ENGLISH = ("the", "world", "we", "have", "to", "think", "about", "energy", "climate", "people")
ARABIC = ("كلام", "تونسي", "باهي", "برشا", "اليوم", "شنوة", "أحوالك", "إنشاء", "آمين", "مرحبا")
SPANISH = ("hola", "mundo", "buenos", "días", "energía", "niño", "señor", "qué", "tal")
FRENCH = ("bonjour", "le", "monde", "très", "où", "été", "français", "garçon")
THAI = ("สวัสดี", "ครับ", "ขอบคุณ", "มาก", "วันนี้", "อากาศ", "ดี")
INDONESIAN = ("selamat", "pagi", "terima", "kasih", "banyak", "hari", "ini")


def _sig(seconds, seed, sr=SR, channels=1):
    """The JAX tests' signals: 0.1 white noise from RandomState(seed), (channels, n)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(channels, int(seconds * sr)) * 0.1).astype(np.float32)


def _wav(path, seconds=1.0, seed=0, sr=SR):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, _sig(seconds, seed, sr), sr)
    return path


def _flac(path, seconds=1.0, seed=0, sr=SR):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_flac(path, _sig(seconds, seed, sr), sr)
    return path


def _words(rng, vocabulary, lo=2, hi=7):
    return " ".join(vocabulary[i] for i in rng.randint(0, len(vocabulary), rng.randint(lo, hi)))


# -- MuST-C ------------------------------------------------------------------------------


def must_c_tree(root, layout="tranche3", tgt="de", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:742 (one 30 s talk per
    split, two rows); ``wide``: two to four talks of 12-20 s per split with
    segments of 1-3 s, German texts (``wide-zh``: the same in an ``en-zh``
    package); ``nonadjacent``: ``wide`` with the rows of the talks
    interleaved, so that no talk's rows are adjacent."""
    if layout == "wide-zh":
        layout, tgt = "wide", "zh"
    data = root / f"en-{tgt}" / "data"
    for s, split in enumerate(jmustc.MUST_C_SPLITS):
        txt = data / split / "txt"
        txt.mkdir(parents=True, exist_ok=True)
        if layout == "tranche3":
            _wav(data / split / "wav" / "ted_767.wav", 30.0, seed=61)
            (txt / f"{split}.yaml").write_text(
                "- {duration: 3.5, offset: 16.08, speaker_id: spk.767, wav: ted_767.wav}\n"
                "- {duration: 2.0, offset: 20.0, speaker_id: spk.767, wav: ted_767.wav}\n")
            (txt / f"{split}.{tgt}").write_text("Hallo Welt\nZweiter Satz\n")
            continue
        rng = np.random.RandomState(seed + s)
        talks = []
        for t in range(4 if split == "train" else 2):
            name = f"ted_{1000 + 10 * s + t}"
            seconds = float(rng.uniform(12.0, 20.0))
            _wav(data / split / "wav" / f"{name}.wav", seconds, seed=seed * 100 + 10 * s + t)
            rows, offset = [], float(rng.uniform(0.0, 1.0))
            while True:
                duration = round(float(rng.uniform(1.0, 3.0)), 6)
                if offset + duration > seconds:
                    break
                rows.append((f"- {{duration: {duration}, offset: {round(offset, 6)}, speaker_id: "
                             f"spk.{1000 + t}, wav: {name}.wav}}", _words(rng, GERMAN)))
                offset += duration + float(rng.uniform(0.1, 1.0))
            talks.append(rows)
        if layout == "nonadjacent":
            rows = [r for k in range(max(map(len, talks))) for rows in talks for r in rows[k:k + 1]]
        else:
            rows = [r for rows in talks for r in rows]
        (txt / f"{split}.yaml").write_text("".join(f"{y}\n" for y, _ in rows))
        (txt / f"{split}.{tgt}").write_text("".join(f"{t}\n" for _, t in rows))
    return (root,), {"tgt_lang": tgt}


# -- IWSLT 2022 Tunisian Arabic ------------------------------------------------------------


def iwslt22_tree(root, layout="tranche3", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:760 and
    tests/test_refdiff_recipes.py:1579 (one 30 s file of WAV data behind a
    ``.sph`` name, two rows, one excluded, empty dev and test1); ``wide``:
    six conversations of 8 kHz PCM SPHERE, rows with markers, punctuation,
    diacritics, Eastern Arabic digits and letters repeated, one row
    duplicated, one whose cleaned text is empty, two excluded, a file
    without translations and a ``._`` file the scan skips, over all three
    splits."""
    corpus, splits = root / "ldc", root / "splits"
    splits.mkdir(parents=True, exist_ok=True)
    audio, tdir = corpus / "data" / "audio" / "ta", corpus / "data" / "transcripts" / "ta"
    xdir = corpus / "data" / "translations" / "ta"
    for d in (audio, tdir, xdir):
        d.mkdir(parents=True, exist_ok=True)
    if layout == "tranche3":
        fname = "20170101_120000_12345_A"
        write_wav(audio / f"{fname}.sph", _sig(30.0, 62, sr=8000), 8000)
        (tdir / f"{fname}.ta.tsv").write_text(
            "1.0\t2.5\tspkA\tO/ kalam tounsi?\n3.0\t4.0\tspkA\texcluded line\n")
        (xdir / f"{fname}.eng.tsv").write_text(
            "1.0\t2.5\tspkA\tTunisian Words!\n3.0\t4.0\tspkA\tdropped.\n")
        (splits / "train.file_id.txt").write_text(f"{fname}\n")
        (splits / "dev.file_id.txt").write_text("")
        (splits / "test1.file_id.txt").write_text("")
        (splits / "exclude-utterance.txt").write_text(f"{fname} 3.0 4.0\n")
        return (corpus, splits), {}
    rng = np.random.RandomState(seed)
    names = [f"2017010{k}_1{k}0000_{12345 + k}_{'AB'[k % 2]}" for k in range(6)]
    excluded = []
    for k, name in enumerate(names):
        write_sph(str(audio / f"{name}.sph"), _sig(20.0, 300 + k, sr=8000), 8000)
        src, tgt, start = [], [], float(rng.uniform(0.2, 1.0))
        for i in range(6):
            end = start + float(rng.uniform(1.0, 2.5))
            text = _words(rng, ARABIC)
            if i == 1:
                text = f"O/ {text}؟ U/"
            elif i == 2:
                text = f"{text}، ٣٤ مرررحبا ووو"
            elif i == 3:
                text = f"{text} بِسْمِ! M/"
            elif i == 4 and k == 2:
                text = "؟ ."  # nothing left once cleaned
            sid = f"spk{k % 3}"
            src.append(f"{start:.2f}\t{end:.2f}\t{sid}\t{text}")
            tgt.append(f"{start:.2f}\t{end:.2f}\t{sid}\t(laughs) {_words(rng, ENGLISH)}, #ok+=!")
            if i == 5 and k in (1, 4):
                excluded.append(f"{name} {start:.2f} {end:.2f}")
            start = end + float(rng.uniform(0.1, 0.8))
        if k == 3:  # a row given twice: one supervision id twice
            src.append(src[2])
            tgt.append(tgt[2])
        order = rng.permutation(len(src))  # the recipe sorts the rows by their start
        (tdir / f"{name}.ta.tsv").write_text("".join(f"{src[i]}\n" for i in order))
        if k != 5:  # no translations: the file is skipped with a warning
            (xdir / f"{name}.eng.tsv").write_text("".join(f"{tgt[i]}\n" for i in order))
    (tdir / f"._{names[0]}.ta.tsv").write_text("resource fork\n")
    (splits / "train.file_id.txt").write_text("".join(f"{n}\n" for n in names[:3]) + "\n")
    (splits / "dev.file_id.txt").write_text(f"{names[3]}\n{names[4]}\n")
    (splits / "test1.file_id.txt").write_text(f"{names[5]}\n")
    (splits / "exclude-utterance.txt").write_text("".join(f"{e}\n" for e in excluded) + "\n")
    return (corpus, splits), {}


# -- mTEDx ---------------------------------------------------------------------------------

VTT_WIDE = (
    "WEBVTT\nKind: captions\nLanguage: {lang}\n\n"
    "1\n00:00:00.500 --> 00:00:02.000\n{a}\n\n"
    "2\n00:00:02.500 --> 00:00:04.250\n{b} (Risas)\n\n"
    "3\n00:00:04.500 --> 00:00:05.000\n(Aplausos)\n\n"
    "00:00:05.500 --> 00:00:07.000\n<i>{c}</i> l'homme &amp; d'un\n\n"
    "5\n00:00:07.250 --> 00:00:08.000\n-\n\n"
    "6\n00:00:08.500 --> 00:00:10.000\n{a} 100€ {b}\n\n"
    "no timing here\n\n"
    "7\n00:00:10.250 --> 00:00:12.750\n- {b}\n- {c}\n")


def mtedx_tree(root, layout="tranche3", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:721 (``es-es``, one 30 s
    FLAC talk per split, a cue with an interior noise span); ``tranche5``:
    tests/test_recipes_tranche5.py:130 and tests/test_refdiff_recipes.py:1747
    (5 s talks, two cues); ``wide``: ``es-es`` and ``fr-fr`` with two talks
    per split, numbered and unnumbered cues, noise spans alone and inside a
    line, HTML tags and entities, apostrophes, a dash-only cue, a word with
    an invalid character, a block without timing and a two-line cue."""
    if layout == "tranche3":
        base = root / "es-es"
        for split in ("train", "valid", "test"):
            _flac(base / "data" / split / "wav" / f"talk_{split}.flac", 30.0, seed=60)
            vtt = base / "data" / split / "vtt"
            vtt.mkdir(parents=True)
            (vtt / f"talk_{split}.es.vtt").write_text(
                "WEBVTT\n\n"
                "1\n00:00:01.000 --> 00:00:03.000\nHola, (Risas) Mundo!\n\n"
                "2\n00:00:04.000 --> 00:00:06.000\n- Buenos dias\n")
        return (root,), {"languages": "es"}
    if layout == "tranche5":
        base = root / "es-es" / "data"
        for split in ("train", "valid", "test"):
            (base / split / "wav").mkdir(parents=True)
            (base / split / "vtt").mkdir(parents=True)
            write_flac(str(base / split / "wav" / f"talk_{split}.flac"), _sig(5.0, 0)[0], SR)
            (base / split / "vtt" / f"talk_{split}.es.vtt").write_text(
                "WEBVTT\n\n00:00:00.500 --> 00:00:02.000\nhola mundo\n\n"
                "00:00:02.500 --> 00:00:04.000\nbuenos dias\n")
        return (root,), {"languages": "es"}
    rng = np.random.RandomState(seed)
    for lang, vocabulary in (("es", SPANISH), ("fr", FRENCH)):
        for s, split in enumerate(("train", "valid", "test")):
            for t in range(2):
                name = f"{lang}talk{s}{t}"
                _flac(root / f"{lang}-{lang}" / "data" / split / "wav" / f"{name}.flac", 13.0,
                      seed=400 + 10 * s + t)
                vtt = root / f"{lang}-{lang}" / "data" / split / "vtt" / f"{name}.{lang}.vtt"
                vtt.parent.mkdir(parents=True, exist_ok=True)
                vtt.write_text(VTT_WIDE.format(
                    lang=lang, **{k: _words(rng, vocabulary).capitalize() for k in "abc"}))
    return (root,), {"languages": "all"}


# -- GigaST --------------------------------------------------------------------------------


def _gigaspeech_manifests(directory, parts):
    """GigaSpeech-format manifests written by the JAX package, as
    tests/test_recipes_tranche4.py:311 writes them: ``parts`` maps a part to
    its supervision ids."""
    from lhotse_tpu.testing.dummies import dummy_recording

    directory.mkdir(parents=True, exist_ok=True)
    for k, (part, ids) in enumerate(parts.items()):
        J.SupervisionSet.from_segments(
            J.SupervisionSegment(id=sid, recording_id=sid.split("_")[0], start=float(i),
                                 duration=1.0, channel=0, text=f"segment {i}")
            for i, sid in enumerate(ids)).to_file(
            directory / f"gigaspeech_supervisions_{part}.jsonl.gz")
        J.RecordingSet([dummy_recording(k)]).to_file(
            directory / f"gigaspeech_recordings_{part}.jsonl.gz")


def gigast_tree(root, layout="tranche4", seed=0):
    """``tranche4``: tests/test_recipes_tranche4.py:311 and
    tests/test_refdiff_recipes.py:2333 (three TEST supervisions, one
    translated); ``wide``: the XL and TEST parts (the defaults) in German
    and Chinese, translations for every other XL segment (with ``extra``)
    and most TEST segments, spread over several audios. One reader runs
    through both parts and drops the line after XL's last match, so a
    filler line separates them."""
    manifests = root / "manifests"
    if layout == "tranche4":
        _gigaspeech_manifests(manifests, {"TEST": [f"POD1_S{i:07d}" for i in range(3)]})
        (root / "GigaST.de.json").write_text(json.dumps({"audios": [{"segments": [
            {"sid": "POD1_S0000001", "text_raw": "Segment eins", "extra": {}}]}]}),
            encoding="utf-8")
        return (root, manifests), {"languages": "de", "dataset_parts": "TEST"}
    rng = np.random.RandomState(seed)
    xl = [f"POD{p}_S{i:07d}" for p in range(3) for i in range(6)]
    test = [f"AUD{p}_S{i:07d}" for p in range(2) for i in range(5)]
    _gigaspeech_manifests(manifests, {"XL": xl, "TEST": test})
    for lang, vocabulary in (("de", GERMAN), ("zh", ("你好", "世界", "今天", "天气", "很", "好"))):
        rows = [{"sid": sid, "text_raw": _words(rng, vocabulary), "extra": {"score": k / 10}}
                for k, sid in enumerate(xl) if k % 2 == 0]
        rows.append({"sid": "FILLER", "text_raw": "", "extra": {}})
        rows += [{"sid": sid, "text_raw": _words(rng, vocabulary), "extra": {}}
                 for k, sid in enumerate(test) if k != 3]
        audios = [{"segments": rows[i:i + 4]} for i in range(0, len(rows), 4)]
        (root / f"GigaST.{lang}.json").write_text(json.dumps({"audios": audios}),
                                                  encoding="utf-8")
    return (root, manifests), {}


# -- VoxPopuli -----------------------------------------------------------------------------

VOX_HEADER = "id|session_id|start_time|end_time|speaker_id|gender|normed_text|original_text|split"


def _voxpopuli_tsv(rows) -> bytes:
    return "\n".join([VOX_HEADER] + rows + [""]).encode()


def voxpopuli_tree(root, layout="tranche2", seed=0):
    """``tranche2``: tests/test_recipes_tranche2.py:429 (one 3 s session of
    WAV data behind an ``.ogg`` name, one train row); ``refdiff``:
    tests/test_refdiff_recipes.py:1717 (a row per split); ``wide``: five
    sessions over two years (one named ``..._original``), rows of all three
    splits, a row of another split and a row of a session without audio.
    The annotation table is returned as bytes, for ``output_dir``."""
    raw = root / "raw_audios" / "en"
    if layout in ("tranche2", "refdiff"):
        _wav(raw / "2020" / "20200101-0900-PLENARY_en.ogg", 3.0, seed=87)
        rows = ["x|20200101-0900-PLENARY|0.5|2.0|spk1|female|good morning|Good morning.|train"]
        if layout == "refdiff":
            rows += ["y|20200101-0900-PLENARY|2.0|2.5|spk1|female|dev words|Dev words.|dev",
                     "z|20200101-0900-PLENARY|2.5|2.9|spk2|male|test words|Test words.|test"]
        return (root,), {"lang": "en"}, _voxpopuli_tsv(rows)
    rng = np.random.RandomState(seed)
    sessions = []
    for k in range(5):
        year = 2019 + k % 2
        name = f"{year}0{k + 1}01-0900-PLENARY-{k}"
        suffix = "_original" if k == 4 else "_en"
        _wav(raw / str(year) / f"{name}{suffix}.ogg", 6.0, seed=500 + k)
        sessions.append(name)
    rows = []
    for k, name in enumerate(sessions):
        start = float(rng.uniform(0.0, 0.5))
        for i in range(3):
            end = start + float(rng.uniform(0.6, 1.5))
            words = _words(rng, ENGLISH)
            split = ("train", "dev", "test")[(k + i) % 3]
            rows.append(f"u{k}{i}|{name}|{start:.3f}|{end:.3f}|spk{k % 3}|"
                        f"{('female', 'male')[i % 2]}|{words}|{words.capitalize()}.|{split}")
            start = end + float(rng.uniform(0.05, 0.4))
    rows.append(f"o1|{sessions[0]}|4.0|4.5|spk0|male|other words|Other words.|other")
    rows.append("m1|20200909-0900-PLENARY-9|1.0|2.0|spk9|male|no audio|No audio.|train")
    return (root,), {"lang": "en"}, _voxpopuli_tsv(rows)


# -- GigaSpeech 2 --------------------------------------------------------------------------


def gigaspeech2_tree(root, layout="tranche3", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:822 and
    tests/test_refdiff_recipes.py:2235 (one Thai dev segment); ``wide``:
    Thai and Indonesian with train_raw and train_refined over one train tree,
    dev and test, a blank line and a row whose audio is missing."""
    if layout == "tranche3":
        lang_dir = root / "data" / "th"
        _wav(lang_dir / "dev" / "0" / "12" / "0-12-3.wav", 1.0, seed=64)
        (lang_dir / "dev.tsv").write_text("0-12-3\tสวัสดี\n")
        return (root,), {}
    rng = np.random.RandomState(seed)
    for lang, vocabulary in (("th", THAI), ("id", INDONESIAN)):
        lang_dir = root / "data" / lang
        for part, tree in (("train_raw", "train"), ("train_refined", "train"), ("dev", "dev"),
                           ("test", "test")):
            lines = []
            for i in range(4):
                sid = f"{i % 2}-{100 + i}-{i}"
                if part != "train_refined":
                    _wav(lang_dir / tree / str(i % 2) / str(100 + i) / f"{sid}.wav",
                         float(rng.uniform(0.5, 1.5)), seed=600 + i)
                lines.append(f"{sid}\t {_words(rng, vocabulary)} ")
            lines.insert(2, "")
            lines.append(f"1-999-7\t{_words(rng, vocabulary)}")  # no such file
            (lang_dir / f"{part}.tsv").write_text("\n".join(lines) + "\n")
    return (root,), {}


# -- Emilia --------------------------------------------------------------------------------


def emilia_tree(root, layout="tranche3", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:788 (one German clip of
    WAV data behind an ``.mp3`` name); ``wide``: English clips in two
    metadata files, one row naming a missing clip."""
    if layout == "tranche3":
        data = root / "raw" / "DE"
        _wav(data / "DE_B00000" / "DE_B00000_S00000" / "mp3" / "DE_B00000_S00000_W000029.mp3",
             seed=63)
        (data / "DE_B00000.jsonl").write_text(json.dumps({
            "id": "DE_B00000_S00000_W000029",
            "wav": "DE_B00000/DE_B00000_S00000/mp3/DE_B00000_S00000_W000029.mp3",
            "text": " Und es gibt auch einen Stadtplan.", "duration": 1.0,
            "speaker": "DE_B00000_S00000", "language": "de", "dnsmos": 3.37}) + "\n")
        return (root,), {"lang": "de"}
    rng = np.random.RandomState(seed)
    data = root / "raw" / "EN"
    for b in range(2):
        rows = []
        for i in range(4):
            utt = f"EN_B0000{b}_S0000{i % 2}_W00000{i}"
            rel = f"EN_B0000{b}/EN_B0000{b}_S0000{i % 2}/wav/{utt}.wav"
            if (b, i) != (1, 2):
                _wav(data / rel, float(rng.uniform(0.5, 2.0)), seed=700 + 10 * b + i)
            rows.append(json.dumps({"id": utt, "wav": rel, "text": _words(rng, ENGLISH),
                                    "duration": 1.0, "speaker": f"EN_B0000{b}_S0000{i % 2}",
                                    "language": "en",
                                    "dnsmos": round(float(rng.uniform(2.5, 3.9)), 4)}))
        (data / f"EN_B0000{b}.jsonl").write_text("\n".join(rows) + "\n")
    return (root,), {"lang": "en"}


# -- BVCC ----------------------------------------------------------------------------------


def bvcc_tree(root, layout="tranche3", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:834 and
    tests/test_refdiff_recipes.py:1666 (one rated utterance per track, one
    test utterance); ``wide``: three systems of two utterances per track,
    two or three listeners each, rows in shuffled order, every gender and
    impairment of the main track and every listener type of the OOD track,
    and unrated test and unlabeled utterances."""
    rng = np.random.RandomState(seed)
    for track in ("main", "ood"):
        data = root / f"phase1-{track}" / "DATA"
        sets = data / "sets"
        sets.mkdir(parents=True, exist_ok=True)
        if layout == "tranche3":
            _wav(data / "wav" / f"sys1-utt_{track}.wav", seed=65)
            _wav(data / "wav" / f"sys1-test_{track}.wav", seed=66)
            info = "{}_20-29_L001_Male_x_x_No" if track == "main" else "{}_na_L001_na_na_na_EE"
            row = f"sys1,sys1-utt_{track}.wav,4,0,{info}\n"
            (sets / "TRAINSET").write_text(row)
            (sets / "DEVSET").write_text(row)
            (sets / "test.scp").write_text(f"sys1-test_{track}.wav\n")
            if track == "ood":
                (sets / "unlabeled_mos_list.txt").write_text(f"sys1-test_{track}.wav\n")
            continue
        rows = {"TRAINSET": [], "DEVSET": []}
        for s in range(3):
            for u in range(2):
                utt = f"sys{s}-utt{u}_{track}"
                _wav(data / "wav" / f"{utt}.wav", float(rng.uniform(0.5, 1.5)),
                     seed=800 + 10 * s + u)
                part = "DEVSET" if (s + u) % 3 == 0 else "TRAINSET"
                for k in range(2 + (s + u) % 2):
                    lid = f"L{k:03d}"
                    if track == "main":
                        gender = ("Male", "Female", "Others")[(s + k) % 3]
                        info = f"x_{20 + 10 * k}-{29 + 10 * k}_{lid}_{gender}_x_x_" \
                               f"{('No', 'Yes')[(u + k) % 2]}"
                    else:
                        info = f"x_na_{lid}_na_na_na_{('EE', 'EP', 'ER')[(s + k) % 3]}"
                    rows[part].append(f"sys{s},{utt}.wav,{1 + (s + u + k) % 5},0,{info}")
        for part, lines in rows.items():
            order = rng.permutation(len(lines))
            (sets / part).write_text("".join(f"{lines[i]}\n" for i in order))
        tests = [f"sys{s}-test_{track}.wav" for s in range(2)]
        for k, name in enumerate(tests):
            _wav(data / "wav" / name, 1.0, seed=850 + k)
        (sets / "test.scp").write_text("".join(f"{n}\n" for n in tests))
        if track == "ood":
            _wav(data / "wav" / "unl-1_ood.wav", 1.0, seed=860)
            (sets / "unlabeled_mos_list.txt").write_text("unl-1_ood.wav\n\n")
    return (root,), {}


# -- each recipe on each layout --------------------------------------------------------------

P = {"must_c": pmustc.prepare_must_c, "iwslt22_ta": piwslt.prepare_iwslt22_ta,
     "mtedx": pmtedx.prepare_mtedx, "gigast": pgigast.prepare_gigast,
     "voxpopuli": pvox.prepare_voxpopuli, "gigaspeech2": pgs2.prepare_gigaspeech2,
     "emilia": pemilia.prepare_emilia, "bvcc": pbvcc.prepare_bvcc}
JP = {"must_c": jmustc.prepare_must_c, "iwslt22_ta": jiwslt.prepare_iwslt22_ta,
      "mtedx": jmtedx.prepare_mtedx, "gigast": jgigast.prepare_gigast,
      "voxpopuli": jvox.prepare_voxpopuli, "gigaspeech2": jgs2.prepare_gigaspeech2,
      "emilia": jemilia.prepare_emilia, "bvcc": jbvcc.prepare_bvcc}
TREES = {"must_c": must_c_tree, "iwslt22_ta": iwslt22_tree, "mtedx": mtedx_tree,
         "gigast": gigast_tree, "voxpopuli": voxpopuli_tree, "gigaspeech2": gigaspeech2_tree,
         "emilia": emilia_tree, "bvcc": bvcc_tree}
CASES = {
    "must_c-tranche3": ("must_c", "tranche3", {}),
    "must_c-wide": ("must_c", "wide", {}),
    "must_c-wide-zh": ("must_c", "wide-zh", {}),
    "iwslt22_ta-tranche3": ("iwslt22_ta", "tranche3", {}),
    "iwslt22_ta-tranche3-normalized": ("iwslt22_ta", "tranche3", {"normalize_text": True}),
    "iwslt22_ta-wide": ("iwslt22_ta", "wide", {}),
    "iwslt22_ta-wide-normalized": ("iwslt22_ta", "wide", {"normalize_text": True}),
    "iwslt22_ta-wide-langs": ("iwslt22_ta", "wide", {"langs": ["aeb", "en"]}),
    "mtedx-tranche3": ("mtedx", "tranche3", {}),
    "mtedx-tranche5": ("mtedx", "tranche5", {}),
    "mtedx-wide": ("mtedx", "wide", {}),
    "mtedx-wide-fr": ("mtedx", "wide", {"languages": ["fr"]}),
    "gigast-tranche4": ("gigast", "tranche4", {}),
    "gigast-wide": ("gigast", "wide", {}),
    "gigast-wide-zh-xl": ("gigast", "wide", {"languages": "zh", "dataset_parts": ["XL"]}),
    "voxpopuli-tranche2": ("voxpopuli", "tranche2", {}),
    "voxpopuli-refdiff": ("voxpopuli", "refdiff", {}),
    "voxpopuli-wide": ("voxpopuli", "wide", {}),
    "gigaspeech2-tranche3": ("gigaspeech2", "tranche3", {}),
    "gigaspeech2-wide": ("gigaspeech2", "wide", {}),
    "gigaspeech2-wide-id": ("gigaspeech2", "wide", {"languages": "id"}),
    "emilia-tranche3": ("emilia", "tranche3", {}),
    "emilia-wide": ("emilia", "wide", {}),
    "bvcc-tranche3": ("bvcc", "tranche3", {}),
    "bvcc-wide": ("bvcc", "wide", {}),
}


def _layout(recipe, root, layout):
    """(args, kwargs) of a recipe's call on its layout; VoxPopuli's
    annotation table is written where each call's ``output_dir`` will be."""
    made = TREES[recipe](root / "corpus", layout)
    if recipe != "voxpopuli":
        return made
    args, kwargs, tsv = made
    for out in ("ours", "jax"):
        (root / out).mkdir(parents=True, exist_ok=True)
        (root / out / "asr_en.tsv.gz").write_bytes(gzip.compress(tsv))
    return args, kwargs


def _prepare(pkg, recipe, args, kwargs, out):
    """One package's ``prepare_*`` after its own ``fix_random_seed(0)``."""
    (fix_random_seed if pkg == "port" else jfix)(0)
    return (P if pkg == "port" else JP)[recipe](*args, output_dir=out, **kwargs)


def _nonempty(made) -> int:
    """The items of every manifest a recipe returned."""
    if isinstance(made, dict):
        return sum(_nonempty(v) for v in made.values())
    return len(list(made))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_equals_jax(tmp_path, case):
    """The returned manifests and every file that each package's
    ``prepare_*`` writes on the same layout are equal."""
    recipe, layout, extra = CASES[case]
    args, kwargs = _layout(recipe, tmp_path, layout)
    kwargs = {**kwargs, **extra}
    ours = _prepare("port", recipe, args, kwargs, tmp_path / "ours")
    theirs = _prepare("jax", recipe, args, kwargs, tmp_path / "jax")
    assert _dicts(ours) == _dicts(theirs)
    written = _files(tmp_path / "ours")
    assert written and written == _files(tmp_path / "jax")
    assert _nonempty(ours) > 0


def test_voxpopuli_equals_jax_at_four_jobs(tmp_path):
    """Four jobs scan the sessions (spawned in the port, forked in JAX, each
    running the picklable ``RecordingIdFn``): the same manifests as one
    job's, and as JAX's."""
    args, kwargs = _layout("voxpopuli", tmp_path, "wide")
    ours = _prepare("port", "voxpopuli", args, {**kwargs, "num_jobs": 4}, tmp_path / "ours")
    theirs = _prepare("jax", "voxpopuli", args, {**kwargs, "num_jobs": 4}, tmp_path / "jax")
    one = P["voxpopuli"](*args, output_dir=tmp_path / "ours", **kwargs)
    assert _dicts(ours) == _dicts(theirs) == _dicts(one)
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")
    assert {r.id for part in ours.values() for r in part["recordings"]} == {
        f"20{19 + k % 2}0{k + 1}01-0900-PLENARY-{k}" for k in range(5)}


# -- what the JAX tests expect ---------------------------------------------------------------


def test_must_c_as_the_jax_test_expects(tmp_path):
    args, kwargs = must_c_tree(tmp_path / "corpus")
    m = P["must_c"](*args, output_dir=tmp_path / "out", **kwargs)
    sups = sorted(m["train"]["supervisions"], key=lambda s: s.start)
    assert len(sups) == 2
    assert sups[0].text == "Hallo Welt" and sups[0].start == 16.08
    assert sups[0].speaker == "spk.767" and sups[0].language == "de"


def test_iwslt22_ta_as_the_jax_tests_expect(tmp_path):
    args, _ = iwslt22_tree(tmp_path / "corpus")
    m = P["iwslt22_ta"](*args, output_dir=tmp_path / "out")
    sups = list(m["train"]["supervisions"])
    assert len(sups) == 1
    assert sups[0].text == " kalam tounsi"
    assert sups[0].custom["translated_text"]["eng"] == "tunisian words"
    assert sups[0].language == "ta"
    assert len(m["dev"]["recordings"]) == len(m["test1"]["supervisions"]) == 0


@pytest.mark.parametrize("layout", ["tranche3", "tranche5"])
def test_mtedx_as_the_jax_tests_expect(tmp_path, layout):
    args, kwargs = mtedx_tree(tmp_path / "corpus", layout)
    m = P["mtedx"](*args, output_dir=tmp_path / "out", **kwargs)
    sups = sorted(m["es"]["train"]["supervisions"], key=lambda s: s.start)
    if layout == "tranche3":  # the cue with an interior noise span is dropped
        assert len(sups) == 1 and sups[0].text == "buenos dias"
        assert sups[0].start == 4.0 and sups[0].duration == 2.0
    else:
        assert [s.text for s in sups] == ["hola mundo", "buenos dias"]
        assert sups[0].start == 0.5 and abs(sups[0].duration - 1.5) < 1e-6
    assert {s.language for s in sups} == {"es"}


def test_mtedx_single_language_equals_jax(tmp_path):
    """``prepare_single_mtedx_language`` (the JAX test's entry point) on
    one package directory, with and without an output directory."""
    args, _ = mtedx_tree(tmp_path / "corpus", "wide")
    root = args[0] / "fr-fr"
    for out in (None, "out"):
        ours = pmtedx.prepare_single_mtedx_language(
            root, output_dir=out and tmp_path / "ours", language="fr")
        theirs = jmtedx.prepare_single_mtedx_language(
            root, output_dir=out and tmp_path / "jax", language="fr")
        assert _dicts(ours) == _dicts(theirs)
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")


def test_gigast_as_the_jax_test_expects_and_a_cached_rerun(tmp_path):
    """One translated TEST segment, and a cached re-run returns it again
    (in both packages)."""
    args, kwargs = gigast_tree(tmp_path / "corpus")
    for pkg in ("port", "jax"):
        first = _prepare(pkg, "gigast", args, kwargs, tmp_path / pkg)
        again = _prepare(pkg, "gigast", args, kwargs, tmp_path / pkg)
        (sup,) = list(first["de-TEST"]["supervisions"])
        assert sup.id == "POD1_S0000001" and sup.custom["text_raw"] == "Segment eins"
        assert _dicts(again) == _dicts(first)


def test_voxpopuli_as_the_jax_test_expects(tmp_path):
    args, kwargs = _layout("voxpopuli", tmp_path, "tranche2")
    m = P["voxpopuli"](*args, output_dir=tmp_path / "ours", **kwargs)
    (sup,) = list(m["train"]["supervisions"])
    assert sup.text == "good morning" and sup.custom["orig_text"] == "Good morning."
    assert set(m) == {"train"}


def test_emilia_gigaspeech2_and_bvcc_as_the_jax_tests_expect(tmp_path):
    args, kwargs = emilia_tree(tmp_path / "emilia")
    (cut,) = list(P["emilia"](*args, num_jobs=1, output_dir=tmp_path / "e", **kwargs))
    assert cut.supervisions[0].language == "de"
    assert cut.supervisions[0].custom["dnsmos"] == pytest.approx(3.37)
    args, kwargs = gigaspeech2_tree(tmp_path / "gs2")
    (sup,) = list(P["gigaspeech2"](*args, output_dir=tmp_path / "g")["th"]["dev"]["supervisions"])
    assert sup.text == "สวัสดี" and sup.language == "th"
    args, _ = bvcc_tree(tmp_path / "bvcc")
    m = P["bvcc"](*args, output_dir=tmp_path / "b")
    assert set(m) == {"main1_dev", "main1_train", "main1_test", "ood1_dev", "ood1_train",
                      "ood1_test", "ood1_unlabeled"}
    (sup,) = list(m["main1_train"]["supervisions"])
    assert sup.custom["MOS"] == {"L001": 4}
    assert sup.custom["listeners"]["L001"]["M_F"] == "M"
    assert "supervisions" not in m["main1_test"]


# -- MuST-C rows that are not adjacent (ROADMAP C2) ------------------------------------------


def test_must_c_rows_not_adjacent_where_jax_raises(tmp_path):
    """The JAX recipe groups a split's rows with ``itertools.groupby``, which
    joins adjacent rows only: a talk whose rows are not adjacent becomes
    two recordings of one id, and its ``fix_manifests`` raises. The port
    groups every row of a wav into one recording, with the same
    supervisions (ids, times, texts) as the rows given adjacent."""
    args, kwargs = must_c_tree(tmp_path / "mixed", "nonadjacent")
    with pytest.raises(AssertionError, match="duplicated IDs"):
        JP["must_c"](*args, output_dir=tmp_path / "jax", **kwargs)
    ours = P["must_c"](*args, output_dir=tmp_path / "ours", **kwargs)
    sorted_args, _ = must_c_tree(tmp_path / "sorted", "wide")
    theirs = JP["must_c"](*sorted_args, output_dir=tmp_path / "jax_sorted", **kwargs)
    for split in jmustc.MUST_C_SPLITS:
        assert len(ours[split]["recordings"]) == len(theirs[split]["recordings"]) >= 2
        strip = (lambda d: {k: v for k, v in d.items() if k != "sources"})
        assert sorted(json.dumps(strip(r.to_dict())) for r in ours[split]["recordings"]) == \
            sorted(json.dumps(strip(r.to_dict())) for r in theirs[split]["recordings"])
        assert sorted((s.to_dict() for s in ours[split]["supervisions"]), key=json.dumps) == \
            sorted((s.to_dict() for s in theirs[split]["supervisions"]), key=json.dumps)
    groups = pmustc._group_segments([{"wav": w} for w in "abab"], list("1234"))
    assert [(len(rows), texts) for rows, texts in groups] == [(2, ["1", "3"]), (2, ["2", "4"])]
    with pytest.raises(AssertionError):
        pmustc._group_segments([{"wav": "a"}], [])
    with pytest.raises(AssertionError):
        jmustc._group_segments([{"wav": "a"}], [])


# -- helpers ---------------------------------------------------------------------------------

ARABIC_LINES = [
    "O/ كلام تونسي؟", "U/ مرحبا، بكم في  نشرة!", "إنشاء الله ٣٤٥ يوم.", "آمين آمين M/",
    "بِسْمِ اللَّهِ", "مرررحبا ووووو ااااا صصص", "\"quoted\" (paren) {brace} ~tilde~ «»",
    "ta marbuta ة and alif maqsura ى", "  spaces   and\ttabs  ", "", "؟ ."]
ENGLISH_LINES = ["Tunisian Words!", "(laughs) yes, #ok+=!", "a: b; c. \"d\"", "PLAIN"]


@pytest.mark.parametrize("line", ARABIC_LINES)
def test_arabic_cleaners_equal_jax(line):
    for name in ("normalize_text_", "normalize_arabic", "remove_punctuations",
                 "remove_extra_space", "text_cleaning"):
        assert getattr(piwslt, name)(line) == getattr(jiwslt, name)(line), name
    assert piwslt.filter_markers(line, "transcript") == jiwslt.filter_markers(line, "transcript")


@pytest.mark.parametrize("line", ENGLISH_LINES)
def test_translation_markers_equal_jax(line):
    assert piwslt.filter_markers(line, "translation") == jiwslt.filter_markers(line, "translation")


def test_iwslt22_helpers_equal_jax(tmp_path):
    with pytest.raises(ValueError, match="not supported"):
        piwslt.filter_markers("x", "gloss")
    with pytest.raises(ValueError, match="not supported"):
        jiwslt.filter_markers("x", "gloss")
    (corpus, splits), _ = iwslt22_tree(tmp_path, "wide")
    assert piwslt.load_splits(splits) == jiwslt.load_splits(splits)
    from lhotse_tpu_torch.supervision import SupervisionSegment

    sups = [J.SupervisionSegment(id=f"s{k % 3}", recording_id="r", start=float(k), duration=1.0)
            for k in range(7)]
    ours = piwslt.deduplicate_supervisions(SupervisionSegment.from_dict(s.to_dict()) for s in sups)
    assert [s.to_dict() for s in ours] == [
        s.to_dict() for s in jiwslt.deduplicate_supervisions(sups)]
    tsv = sorted((corpus / "data" / "transcripts" / "ta").glob("2*.tsv"))[3]
    xtsv = corpus / "data" / "translations" / "ta" / tsv.name.replace(".ta.", ".eng.")
    for normalize in (False, True):
        ours = piwslt._filename_to_supervisions(tsv, xtsv, normalize, [], ["ta", "eng"])
        theirs = jiwslt._filename_to_supervisions(tsv, xtsv, normalize, [], ["ta", "eng"])
        assert [s.to_dict() for s in ours] == [s.to_dict() for s in theirs] and len(ours) == 7


def test_download_iwslt22_ta_logs_as_jax(caplog):
    """The one download the port keeps: it downloads nothing, and logs the
    same pointer to the LDC catalogue and the split lists."""
    with caplog.at_level(logging.INFO):
        piwslt.download_iwslt22_ta()
        jiwslt.download_iwslt22_ta()
    ours, theirs = (r.getMessage() for r in caplog.records[-2:])
    assert ours == theirs and "iwslt22-dialect" in ours


VTT_CUES = [
    "Hola, (Risas) Mundo!", "- Buenos dias", "(Aplausos)", "<i>texto</i> &amp; l'homme",
    "100€ señor", "tab nbsp and thin", "naïve café — ¿qué?", "-", "d’un l'été",
    "Ελληνικά και русский", "مرحبا بكم", "(Música) (Risas)"]


@pytest.mark.parametrize("cue", VTT_CUES)
def test_vtt_parser_and_word_filters_equal_jax(cue):
    vtt = f"WEBVTT\n\n7\n01:02:03.250 --> 01:02:05.500\n{cue}\n\n"
    assert list(pmtedx._parse_vtt(vtt, "<noise>")) == list(jmtedx._parse_vtt(vtt, "<noise>"))
    for w in cue.split():
        assert pmtedx._filter_word(w) == jmtedx._filter_word(w)
    assert pmtedx._clean_part(cue) == jmtedx._clean_part(cue)


def test_mtedx_tables_and_times_equal_jax(tmp_path):
    for name in ("VALID_CATEGORIES", "KEEP_LIST", "ASR", "ISOCODE2LANG"):
        assert getattr(pmtedx, name) == getattr(jmtedx, name)
    for t in ("00:00:01.000", "01:02:03.250", "10:59:59.999"):
        assert pmtedx._time2sec(t) == jmtedx._time2sec(t)
    assert pmtedx._parse_time_segment("00:00:01.5 --> 00:01:00.25") == \
        jmtedx._parse_time_segment("00:00:01.5 --> 00:01:00.25")
    for languages in ("all", ["all"], "es", ["es", "fr"], []):
        assert pmtedx._resolve_languages(languages) == jmtedx._resolve_languages(languages)
    args, _ = mtedx_tree(tmp_path, "wide")
    vtt = sorted(args[0].rglob("*.vtt"))[0]
    assert [s.to_dict() for s in pmtedx._filename_to_supervisions(vtt, "es")] == [
        s.to_dict() for s in jmtedx._filename_to_supervisions(vtt, "es")]


BVCC_MAIN = ["sys1,u1.wav,4,0,x_20-29_L001_Male_x_x_No", "sysB,u2,1,0,y_50-59_L9_Female_a_b_Yes",
             "s,u,5,0,z_na_L2_Others_c_d_No"]
BVCC_OOD = ["sys1,u1.wav,4,0,x_na_L001_na_na_na_EE", "s,u,2,0,a_b_L5_c_d_e_ER"]


def test_bvcc_parsers_equal_jax(tmp_path):
    for line in BVCC_MAIN:
        assert pbvcc.parse_main_line(line) == jbvcc.parse_main_line(line)
    for line in BVCC_OOD:
        assert pbvcc.parse_ood_line(line) == jbvcc.parse_ood_line(line)
    for bad, parse in (("s,u,1,0,x_1_L_Unknown_x_x_No", "parse_main_line"),
                       ("s,u,1,0,x_1_L_Male_x_x_Maybe", "parse_main_line"),
                       ("s,u,1,0,x_1_L_x_x_x_XX", "parse_ood_line")):
        for module in (pbvcc, jbvcc):
            with pytest.raises(AssertionError):
                getattr(module, parse)(bad)
    args, _ = bvcc_tree(tmp_path, "wide")
    wav = args[0] / "phase1-main" / "DATA" / "wav"
    lines = (args[0] / "phase1-main" / "DATA" / "sets" / "TRAINSET").read_text().splitlines()
    pool = {r.id: r for r in J.RecordingSet.from_dir(wav, "*.wav")}
    ours = list(pbvcc.gen_supervision_per_utt(sorted(lines), pool, pbvcc.parse_main_line))
    theirs = list(jbvcc.gen_supervision_per_utt(sorted(lines), pool, jbvcc.parse_main_line))
    assert [s.to_dict() for s in ours] == [s.to_dict() for s in theirs] and len(ours) >= 3


def test_voxpopuli_tables_and_recording_ids_equal_jax(tmp_path):
    import pickle

    for name in ("LANGUAGES", "LANGUAGES_V2", "YEARS", "ASR_LANGUAGES", "ASR_ACCENTED_LANGUAGES",
                 "S2S_SRC_LANGUAGES", "S2S_TGT_LANGUAGES",
                 "S2S_TGT_LANGUAGES_WITH_HUMAN_TRANSCRIPTION", "DOWNLOAD_BASE_URL",
                 "_SUBSET_LANGS", "_SUBSET_YEARS"):
        assert getattr(pvox, name) == getattr(jvox, name), name
    fn = pickle.loads(pickle.dumps(pvox.RecordingIdFn("de")))
    for stem in ("20200101-0900-PLENARY_de", "20200101-0900-PLENARY_original", "a_de_original",
                 "plain", "x_de_de"):
        path = tmp_path / f"{stem}.ogg"
        assert fn(path) == jvox.RecordingIdFn("de")(path)
    for name in ("GIGASPEECH2_URL", "GIGASPEECH2_LANGS", "GIGASPEECH2_SPLITS"):
        assert getattr(pgs2, name) == getattr(jgs2, name)
    assert pgigast.GIGASPEECH_PARTS == jgigast.GIGASPEECH_PARTS
    assert pgigast.GIGAST_LANGS == jgigast.GIGAST_LANGS
    assert pemilia.EMILIA_LANGS == jemilia.EMILIA_LANGS


def test_gigast_reader_equals_jax(tmp_path):
    (root, _), _ = gigast_tree(tmp_path, "wide")
    ours, theirs = pgigast.GigaST(root, "de"), jgigast.GigaST(root, "de")
    lines = []
    while True:
        try:
            a = ours.get_next_line()
        except StopIteration:
            with pytest.raises(StopIteration):
                theirs.get_next_line()
            break
        assert a == theirs.get_next_line()
        lines.append(a)
    assert len(lines) == 19


# -- cached re-runs --------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", ["gigast", "gigaspeech2"])
def test_cached_rerun_returns_what_the_first_run_did(tmp_path, recipe):
    """A second call finds its manifests in ``output_dir`` and reads them
    back (GigaSpeech 2 eagerly where its first run was lazy): in both
    packages it returns what the first run did, and writes nothing new."""
    args, kwargs = _layout(recipe, tmp_path, "wide")
    runs = {}
    for pkg in ("port", "jax"):
        out = tmp_path / ("ours" if pkg == "port" else "jax")
        first = _dicts(_prepare(pkg, recipe, args, kwargs, out))
        files = _files(out)
        runs[pkg] = (first, _dicts(_prepare(pkg, recipe, args, kwargs, out)))
        assert _files(out) == files
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == runs["port"][1]


def test_gigaspeech2_partly_cached_equals_jax(tmp_path):
    """With one part's manifests deleted, a re-run prepares that part and
    reads the others back, in both packages alike."""
    args, kwargs = gigaspeech2_tree(tmp_path / "corpus", "wide")
    made = {}
    for pkg, out in (("port", tmp_path / "ours"), ("jax", tmp_path / "jax")):
        _prepare(pkg, "gigaspeech2", args, kwargs, out)
        for kind in ("recordings", "supervisions"):
            (out / f"gigaspeech2-th_{kind}_dev.jsonl.gz").unlink()
        made[pkg] = _dicts(_prepare(pkg, "gigaspeech2", args, kwargs, out))
    assert made["port"] == made["jax"] and len(made["port"]["th"]["dev"]["recordings"]) == 4
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")


# -- broken layouts --------------------------------------------------------------------------


def _drop(path):
    if path.is_dir():
        import shutil

        shutil.rmtree(path)
    else:
        path.unlink()


BROKEN = {
    # case: (recipe, layout, break the layout, call's extra kwargs)
    "must_c-missing-split": ("must_c", "wide", lambda r: _drop(r / "corpus/en-de/data/tst-HE"), {}),
    "must_c-missing-package": ("must_c", "wide", None, {"tgt_lang": "fr"}),
    "must_c-short-transcripts": (
        "must_c", "tranche3",
        lambda r: (r / "corpus/en-de/data/dev/txt/dev.de").write_text("Hallo Welt\n"), {}),
    "must_c-missing-wav": ("must_c", "tranche3",
                           lambda r: _drop(r / "corpus/en-de/data/train/wav/ted_767.wav"), {}),
    "iwslt22_ta-missing-split-list": (
        "iwslt22_ta", "wide", lambda r: _drop(r / "corpus/splits/dev.file_id.txt"), {}),
    "iwslt22_ta-missing-exclusions": (
        "iwslt22_ta", "wide", lambda r: _drop(r / "corpus/splits/exclude-utterance.txt"), {}),
    "iwslt22_ta-missing-audio": (
        "iwslt22_ta", "tranche3",
        lambda r: _drop(r / "corpus/ldc/data/audio/ta/20170101_120000_12345_A.sph"), {}),
    "gigast-unknown-language": ("gigast", "tranche4", None, {"languages": "fr"}),
    "gigast-missing-manifests": ("gigast", "wide", None, {"dataset_parts": ["XL", "DEV"]}),
    "gigast-no-corpus": ("gigast", "tranche4", lambda r: _drop(r / "corpus/GigaST.de.json"), {}),
    "voxpopuli-s2s": ("voxpopuli", "tranche2", None, {"task": "s2s"}),
    "voxpopuli-language": ("voxpopuli", "tranche2", None, {"lang": "mt"}),
    "voxpopuli-no-corpus": ("voxpopuli", "tranche2", lambda r: _drop(r / "corpus"), {}),
    "gigaspeech2-no-language": ("gigaspeech2", "tranche3", lambda r: _drop(r / "corpus/data/th"),
                                {}),
    "gigaspeech2-no-output-dir": ("gigaspeech2", "tranche3", None, {"output_dir": None}),
    "emilia-language": ("emilia", "tranche3", None, {"lang": "xx"}),
    "emilia-no-language": ("emilia", "tranche3", None, {"lang": None}),
    "emilia-missing-language-dir": ("emilia", "tranche3", None, {"lang": "fr"}),
    "bvcc-missing-track": ("bvcc", "tranche3", lambda r: _drop(r / "corpus/phase1-ood"), {}),
    "bvcc-missing-sets": ("bvcc", "tranche3", lambda r: _drop(r / "corpus/phase1-main/DATA/sets"),
                          {}),
    "bvcc-missing-rated-wav": (
        "bvcc", "tranche3", lambda r: _drop(r / "corpus/phase1-main/DATA/wav/sys1-utt_main.wav"),
        {}),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_refuses_as_jax(tmp_path, case):
    """On a broken layout or a refused argument both packages raise the
    same error, with the same message."""
    recipe, layout, breaker, extra = BROKEN[case]
    args, kwargs = _layout(recipe, tmp_path, layout)
    if breaker is not None:
        breaker(tmp_path)
    errors = []
    for pkg in ("port", "jax"):
        call = {"output_dir": tmp_path / ("ours" if pkg == "port" else "jax"), **kwargs, **extra}
        with pytest.raises(Exception) as info:
            (P if pkg == "port" else JP)[recipe](*args, **call)
        errors.append((type(info.value).__name__,
                       str(info.value).replace(str(tmp_path / "ours"), "<out>")
                       .replace(str(tmp_path / "jax"), "<out>")))
    assert errors[0] == errors[1]


def test_iwslt22_ta_file_without_translations_is_skipped_as_in_jax(tmp_path, caplog):
    args, _ = iwslt22_tree(tmp_path / "corpus", "wide")
    with caplog.at_level(logging.WARNING):
        ours = P["iwslt22_ta"](*args)
    warned = [r.getMessage() for r in caplog.records if "number of translations" in r.getMessage()]
    assert len(warned) == 1
    theirs = JP["iwslt22_ta"](*args)
    assert _dicts(ours) == _dicts(theirs)
    assert len(ours["test1"]["recordings"]) == len(ours["test1"]["supervisions"]) == 0
    dev_ids = [s.id for s in ours["dev"]["supervisions"]]
    assert len(dev_ids) == len(set(dev_ids)) == 11  # a duplicate and an exclusion dropped


# -- the downloads left out ------------------------------------------------------------------


def test_downloads_are_left_out():
    """The port defines none of the JAX modules' downloads (but IWSLT 2022
    Tunisian's, which downloads nothing), and its modules import no network
    library."""
    left_out = {pmtedx: ("download_mtedx",), pgigast: ("download_gigast",),
                pvox: ("download_voxpopuli",), pbvcc: ("download_bvcc",)}
    jax_modules = {pmtedx: jmtedx, pgigast: jgigast, pvox: jvox, pbvcc: jbvcc}
    for module, names in left_out.items():
        for name in names:
            assert hasattr(jax_modules[module], name)
            assert not hasattr(module, name), f"{module.__name__}.{name}"
    for module in (pmustc, piwslt, pmtedx, pgigast, pvox, pgs2, pemilia, pbvcc):
        source = open(module.__file__).read()
        assert "urllib" not in source and "requests" not in source
        assert "resumable_download" not in source


@pytest.mark.parametrize("output_dir", ["out", None])
def test_voxpopuli_without_its_table_raises_where_jax_downloads(tmp_path, monkeypatch, output_dir):
    """Without ``asr_en.tsv.gz`` in ``output_dir`` (or the working directory)
    the JAX recipe downloads it; the port raises ``NotImplementedError``
    naming the same URL and path."""
    args, kwargs, _ = voxpopuli_tree(tmp_path / "corpus")
    monkeypatch.chdir(tmp_path)
    fetched = []

    def no_network(url, filename, **kw):
        fetched.append((url, str(filename)))
        raise ConnectionError("no network in this test")

    monkeypatch.setattr(jvox, "resumable_download", no_network)
    out = tmp_path / output_dir if output_dir else None
    with pytest.raises(ConnectionError):
        JP["voxpopuli"](*args, output_dir=out, **kwargs)
    with pytest.raises(NotImplementedError) as info:
        P["voxpopuli"](*args, output_dir=out, **kwargs)
    ((url, path),) = fetched
    assert url == "https://dl.fbaipublicfiles.com/voxpopuli/annotations/asr/asr_en.tsv.gz"
    assert url in str(info.value) and path in str(info.value)


# -- the prepare commands --------------------------------------------------------------------

COMMANDS = {
    # command: (argv from (args, kwargs) of the layout, the layout maker, the function's call)
    "must-c": (lambda a, k: ["must-c", a[0], "{out}", "--tgt-lang", "de", "-j", "2"],
               lambda r: must_c_tree(r, "wide"),
               lambda a, k, o: P["must_c"](a[0], o, tgt_lang="de", num_jobs=2)),
    "iwslt22-ta": (lambda a, k: ["iwslt22-ta", *a, "{out}", "--normalize-text", "--langs",
                                 "aeb,en"],
                   lambda r: iwslt22_tree(r, "wide"),
                   lambda a, k, o: P["iwslt22_ta"](*a, output_dir=o, normalize_text=True,
                                                   langs=["aeb", "en"])),
    "mtedx": (lambda a, k: ["mtedx", a[0], "{out}", "-l", "es", "-l", "fr"],
              lambda r: mtedx_tree(r, "wide"),
              lambda a, k, o: P["mtedx"](a[0], o, languages=["es", "fr"])),
    "gigast": (lambda a, k: ["gigast", *a, "{out}", "-l", "de", "-p", "XL", "-p", "TEST"],
               lambda r: gigast_tree(r, "wide"),
               lambda a, k, o: P["gigast"](*a, o, languages=["de"],
                                           dataset_parts=["XL", "TEST"])),
    "voxpopuli": (lambda a, k: ["voxpopuli", a[0], "{out}", "--lang", "en", "-j", "1"],
                  lambda r: voxpopuli_tree(r, "wide"),
                  lambda a, k, o: P["voxpopuli"](a[0], output_dir=o, lang="en")),
    "gigaspeech2": (lambda a, k: ["gigaspeech2", a[0], "{out}", "-l", "th"],
                    lambda r: gigaspeech2_tree(r, "wide"),
                    lambda a, k, o: P["gigaspeech2"](a[0], output_dir=o, languages=["th"])),
    "emilia": (lambda a, k: ["emilia", a[0], "{out}", "--lang", "en"],
               lambda r: emilia_tree(r, "wide"),
               lambda a, k, o: P["emilia"](a[0], lang="en", output_dir=o)),
    "bvcc": (lambda a, k: ["bvcc", a[0], "{out}", "-nj", "1"],
             lambda r: bvcc_tree(r, "wide"),
             lambda a, k, o: P["bvcc"](a[0], output_dir=o)),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_prepare_command_writes_what_its_function_writes(tmp_path, name):
    """Each ``prepare`` command writes the files its function writes, and
    the JAX CLI's command the same, with the output directory replaced."""
    from test_torch_cli import _both as both_clis

    argv, build, function = COMMANDS[name]
    made = build(tmp_path / "corpus")
    args, kwargs = made[:2]
    if name == "voxpopuli":  # the annotation table is read from the output directory
        for out in ("port", "jax", "function"):
            (tmp_path / out).mkdir()
            (tmp_path / out / "asr_en.tsv.gz").write_bytes(gzip.compress(made[2]))
    runs = both_clis(tmp_path, "prepare", *argv(args, kwargs))
    function(args, kwargs, tmp_path / "function")
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    ours = _files(pout)
    assert ours and ours == _files(tmp_path / "function") == _files(jout)


# -- the slice: MuST-C into the on-device chain, IWSLT 2022 into the translation dataset ------


@pytest.fixture(scope="module")
def must_c_slice(tmp_path_factory):
    root = tmp_path_factory.mktemp("must_c_slice")
    args, kwargs = must_c_tree(root / "corpus", "wide")
    made = {}
    for pkg, CS in (("port", CutSet), ("jax", J.CutSet)):
        (fix_random_seed if pkg == "port" else jfix)(0)
        m = (P if pkg == "port" else JP)["must_c"](*args, output_dir=root / pkg, **kwargs)
        made[pkg] = CS.from_manifests(
            recordings=m["train"]["recordings"], supervisions=m["train"]["supervisions"]
        ).trim_to_supervisions(keep_overlapping=False).to_eager()
    return root, list(made["port"]), list(made["jax"])


def test_must_c_segments_through_the_augmenter_equal_jax(must_c_slice):
    """The first 12 trimmed MuST-C train segments (1-3 s), in batches of the
    3 s x 4 bucket through each package's augmenter with the same MUSAN
    noise pool and real RIR, speed 1.1, SNR (10, 20) and SpecAugment: the
    port within ``AUG_TOL`` of the JAX augmenter whose fbank stage is its
    kernel route in float64."""
    root, ours, theirs = must_c_slice
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs] and len(ours) >= 12
    assert all(1.0 <= c.duration <= 3.0 for c in ours)
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
    batches = _bucketed(ours[:12], (3.0, 4))
    for (audio, lens), (jaudio, jlens) in zip(batches, _bucketed(theirs[:12], (3.0, 4))):
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


def test_iwslt22_ta_through_the_translation_dataset_equals_jax(tmp_path, monkeypatch):
    """The wide IWSLT 2022 Tunisian Arabic train split, cleaned, trimmed to
    its supervisions and resampled from 8 to 16 kHz, through
    ``K2Speech2TextTranslationDataset`` with ``OnTheFlyFeatures`` in batches
    of four: the port's features within ``EXTRACTOR_TOL`` of the JAX
    extractor's host chain in float64, the texts and translations equal to
    JAX's and to those of the batch's supervisions."""
    args, _ = iwslt22_tree(tmp_path / "corpus", "wide")
    made = {}
    for pkg, CS in (("port", CutSet), ("jax", J.CutSet)):
        (fix_random_seed if pkg == "port" else jfix)(0)
        m = (P if pkg == "port" else JP)["iwslt22_ta"](*args, normalize_text=True)
        made[pkg] = list(CS.from_manifests(
            recordings=m["train"]["recordings"], supervisions=m["train"]["supervisions"]
        ).trim_to_supervisions(keep_overlapping=False).resample(SR))
    ours, theirs = made["port"], made["jax"]
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs] and len(ours) >= 12
    dataset = K2Speech2TextTranslationDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    j64 = JTranslation(return_cuts=True, input_strategy=JOnTheFly(JFbank(JFbankConfig(device="cpu"))))
    monkeypatch.setenv("LHOTSE_TPU_HOST_FFT_DTYPE", "float64")
    tgt = []
    for i in range(0, len(ours), 4):
        a = dataset[CutSet.from_cuts(ours[i:i + 4])]
        b = j64[J.CutSet.from_cuts(theirs[i:i + 4])]
        x, y = np.asarray(a["inputs"]), np.asarray(b["inputs"])
        assert x.shape == y.shape and np.isfinite(x).all()
        np.testing.assert_allclose(x, y, rtol=0, atol=EXTRACTOR_TOL)
        for key in ("text", "tgt_text", "sequence_idx", "start_frame", "num_frames"):
            assert np.array_equal(np.asarray(a["supervisions"][key], dtype=object),
                                  np.asarray(b["supervisions"][key], dtype=object)), key
        cuts = a["supervisions"]["cut"]
        assert a["supervisions"]["tgt_text"] == [
            s.custom["translated_text"] for c in cuts for s in c.supervisions]
        tgt += a["supervisions"]["tgt_text"]
    assert len(tgt) == len(ours) and all(t["eng"] for t in tgt)
