"""
The port's large ASR training corpus recipes (lhotse_tpu_torch.recipes
``ksponspeech``, ``nsc``, ``babel``, ``heroico``, ``icmcasr``,
``reazonspeech`` and ``bengaliai_speech``) against the JAX package's, on
the fixture layouts of tests/test_recipes_tranche2.py:91,481,
tests/test_recipes_tranche3.py:556,608,656,682,929,
tests/test_recipes_tranche4.py:104,178 and tests/test_recipes_tranche13.py:20
(made from the same numpy seeds), and on wider layouts of the same formats:
KsponSpeech's four parts with the eval prefix, Korean rows with noise labels,
dual transcripts and marks, and a missing file (``normalize_text`` on and
off); NSC parts 1 (zipped, reused on the second run), 3 (``SameCloseMic``
and ``SeparateIVR``), 4, 5 and 6 with ``<S>``/``<Z>`` intervals, clipped
durations, utf-16 and binary TextGrids, and the refusal of
``SameBoundaryMic``; BABEL with dev transcripts, eval transcripts withheld,
real 8 kHz SPHERE and timestamp glitches; Heroico's three folds with
ISO-8859-1 prompts; ICMC-ASR under ``ihm``, ``sdm`` and ``mdm``;
ReazonSpeech over 1,116 rows and a cached re-run; Bengali.AI Speech as real
MP3. Also their helpers (``normalize``, ``_ja_number``, the PCM to FLAC
conversion bit for bit), the two JAX faults the port keeps out (ROADMAP C2),
the downloads they leave out, their ``prepare`` commands through both CLIs,
and the slice at a small size: KsponSpeech utterances through each package's
``OnDeviceAugmenter`` (within ``AUG_TOL`` of the JAX augmenter with its
fbank layer's kernel route in float64), and ICMC-ASR's four-channel ``mdm``
recordings loaded by both packages.
"""
import io
import json
import zipfile

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac
from lhotse_tpu.audio.sphio import write_sph
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.recipes import babel as jbabel
from lhotse_tpu.recipes import bengaliai_speech as jbengali
from lhotse_tpu.recipes import heroico as jheroico
from lhotse_tpu.recipes import icmcasr as jicmc
from lhotse_tpu.recipes import ksponspeech as jkspon
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import nsc as jnsc
from lhotse_tpu.recipes import reazonspeech as jreazon
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.audio import syscodecs
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.recipes import babel as pbabel
from lhotse_tpu_torch.recipes import bengaliai_speech as pbengali
from lhotse_tpu_torch.recipes import heroico as pheroico
from lhotse_tpu_torch.recipes import icmcasr as picmc
from lhotse_tpu_torch.recipes import ksponspeech as pkspon
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import nsc as pnsc
from lhotse_tpu_torch.recipes import reazonspeech as preazon
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_recipes_asr import _dicts
from test_torch_recipes_noise import AUG_TOL, musan_tree, noise_pool, rir_noise_tree, seeded_rir
from test_torch_recipes_overlap import _files
from test_torch_recipes_zh import _JaxKernelRoute64, _bucketed

SR = 16000
KOREAN = ("안녕", "하세요", "오늘", "날씨", "정말", "좋네요", "그래서", "우리", "같이", "밥", "먹자",
          "진짜")
ENGLISH = ("okay", "can", "lah", "we", "go", "makan", "first", "then", "see", "how", "leh")
CANTONESE = ("佢", "哋", "喺", "度", "食", "緊", "嘢", "我", "唔", "係", "好")
SPANISH = ("hola", "amigo", "buenos", "días", "cómo", "estás", "señor", "niño", "qué", "tal")
MANDARIN = ("你好", "世界", "打开", "空调", "导航", "到", "公司", "播放", "音乐", "关闭", "车窗")
JAPANESE = ("こんにちは", "今日は", "いい", "天気", "ですね", "１２３", "、", "。", "ＡＢＣ", "3.5")
BENGALI = ("বাংলা", "বাক্য", "আমি", "তুমি", "ভালো", "আছি", "আজ", "কাল")


def _sig(seconds, seed, sr=SR, channels=1):
    """The JAX tests' signals: 0.1 white noise from RandomState(seed), (channels, n)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(channels, int(seconds * sr)) * 0.1).astype(np.float32)


def _wav(path, seconds=1.0, seed=0, sr=SR, channels=1):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, _sig(seconds, seed, sr, channels), sr)
    return path


def _flac(path, seconds=1.0, seed=0, sr=SR):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_flac(path, _sig(seconds, seed, sr), sr)
    return path


def _words(rng, vocabulary, lo=2, hi=6, sep=" "):
    return sep.join(vocabulary[i] for i in rng.randint(0, len(vocabulary), rng.randint(lo, hi)))


def _textgrid(tiers, xmax) -> str:
    """A long-format Praat TextGrid of ``{name: [(xmin, xmax, text), ...]}``."""
    out = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
           f"xmax = {xmax}", "tiers? <exists>", f"size = {len(tiers)}", "item []:"]
    for k, (name, intervals) in enumerate(tiers.items(), 1):
        out += [f"    item [{k}]:", '        class = "IntervalTier"', f'        name = "{name}"',
                "        xmin = 0", f"        xmax = {xmax}",
                f"        intervals: size = {len(intervals)}"]
        for i, (a, b, text) in enumerate(intervals, 1):
            out += [f"        intervals [{i}]:", f"            xmin = {a}",
                    f"            xmax = {b}", f'            text = "{text}"']
    return "\n".join(out) + "\n"


# -- KsponSpeech -----------------------------------------------------------------------------

KSPON_LINES = (
    "a/b.pcm :: o/ (7%)/(칠 퍼센트) 정도+  맞다/",
    "KsponSpeech_01/KsponSpeech_0001/KsponSpeech_000001.pcm :: 아/ 몬 소리야+, (3프로)/(삼 프로) 진짜*",
    "x.pcm :: b/ n/ 그래서 (2시)/(두 시)에 (10분)/(십 분) 만나* 자+ / l/",
    "y.pcm :: 그냥  평범한   문장",
    "KsponSpeech_eval/KsponSpeech_E00001.pcm :: u/ (1)/(일) 번 *",
)


def ksponspeech_tree(root, layout="wide", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:608 (one 1 s sine PCM,
    a train table); ``tranche4``: tests/test_recipes_tranche4.py:104 (one
    utterance in the published layout); ``wide``: all four parts in the
    published layout, 1-3 s utterances (16 train, 4 dev, 3 of each eval
    part under the ``KsponSpeech_eval/`` prefix), rows of Korean words with
    noise labels, dual transcripts and ``*``/``+``/``/`` marks, and a train
    row whose file is missing."""
    root.mkdir(parents=True, exist_ok=True)
    if layout == "tranche3":
        pcm = (np.sin(np.arange(16000) / 30.0) * 8000).astype("<i2")
        (root / "KsponSpeech_01").mkdir()
        pcm.tofile(root / "KsponSpeech_01" / "u1.pcm")
        (root / "train.trn").write_text(
            "KsponSpeech_01/u1.pcm :: 안녕 (3)/(삼) 하세요\n", encoding="utf-8")
        return (root,), {"dataset_parts": ["train"]}
    if layout == "tranche4":
        pcm = (np.random.RandomState(9).randn(16000) * 3000).astype("<i2")
        rel = "KsponSpeech_01/KsponSpeech_0001/KsponSpeech_000001.pcm"
        (root / rel).parent.mkdir(parents=True)
        (root / rel).write_bytes(pcm.tobytes())
        (root / "train.trn").write_text(
            f"{rel} :: 아/ 몬 소리야+, (3프로)/(삼 프로) 진짜*\n", encoding="utf-8")
        return (root,), {"dataset_parts": "train"}
    rng = np.random.RandomState(seed)
    counts = {"train": 16, "dev": 4, "eval_clean": 3, "eval_other": 3}
    n = 0
    for part, count in counts.items():
        rows = []
        for _ in range(count):
            n += 1
            if part.startswith("eval"):
                rel = f"KsponSpeech_eval/KsponSpeech_E{n:05d}.pcm"
                path = root / rel.split("/", 1)[1]
            else:
                rel = f"KsponSpeech_01/KsponSpeech_{(n - 1) // 10 + 1:04d}/KsponSpeech_{n:06d}.pcm"
                path = root / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            samples = rng.uniform(1.0, 3.0) * SR
            (rng.randn(int(samples)) * 3000).astype("<i2").tofile(path)
            words = [KOREAN[i] for i in rng.randint(0, len(KOREAN), rng.randint(2, 6))]
            words[0] = "o/ " + words[0]
            words[-1] += rng.choice(["*", "+", "/", ""])
            if rng.rand() < 0.5:
                words.insert(1, f"({rng.randint(1, 99)}프로)/({KOREAN[rng.randint(0, 12)]} 프로)")
            rows.append(f"{rel} :: {' '.join(words)}")
        if part == "train":
            rows.insert(3, "KsponSpeech_01/KsponSpeech_0009/KsponSpeech_999999.pcm :: 없는 파일")
        (root / f"{part}.trn").write_text("\n".join(rows) + "\n\n", encoding="utf-8")
    return (root,), {}


# -- NSC -------------------------------------------------------------------------------------

NSC_P13 = "IMDA - National Speech Corpus"
NSC_P46 = ("IMDA - National Speech Corpus - Additional/"
           "IMDA - National Speech Corpus (Additional)")


def _nsc_intervals(rng, seconds, marks=True):
    """(xmin, xmax, text) intervals covering [0, seconds + 1], with ``<S>`` and
    ``<Z>`` ones; the last runs one second past the audio (clipped), and one
    starts past it (dropped)."""
    out, t = [], 0.0
    while t < seconds - 1.0:
        end = round(min(t + rng.uniform(0.5, 2.5), seconds - 0.5), 3)
        text = _words(rng, ENGLISH) if not marks or rng.rand() < 0.7 else rng.choice(["<S>", "<Z>"])
        out.append((round(t, 3), end, text))
        t = end
    out.append((round(t, 3), round(seconds + 1.0, 3), "past the end"))
    out.append((round(seconds + 1.0, 3), round(seconds + 2.0, 3), "after the end"))
    return out


def nsc_tree(root, layout="PART3_SameCloseMic", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:929 (one 10 s
    conversation, ``<S>``, a text and ``<Z>``); each other layout writes the
    named part in its published directories: ``PART1_CHANNEL0`` two speaker
    zips of two sessions with scripts of alternating id and text rows (a row
    without audio among them); ``PART3_SameCloseMic`` four conversations of
    4-6 s, one TextGrid in utf-16, one binary, one whose tier has another
    name and one without a TextGrid; ``PART3_SeparateIVR`` two session
    directories whose TextGrids carry the session prefix; ``PART4_...``,
    ``PART5_Debate`` and ``PART6_CallCentreDesign1`` three files each, their
    TextGrids of two tiers (the first is read)."""
    rng = np.random.RandomState(seed)
    if layout == "tranche3":
        part3 = root / NSC_P13 / "PART3"
        _wav(part3 / "Audio Same CloseMic" / "conf_0001.wav", 10.0, 72)
        (part3 / "Scripts Same").mkdir(parents=True)
        (part3 / "Scripts Same" / "conf_0001.TextGrid").write_text(_textgrid(
            {"conf_0001": [(0.0, 1.0, "<S>"), (1.0, 3.0, "lah okay can"), (3.0, 10.0, "<Z>")]},
            10))
        return (root,), {"dataset_part": "PART3_SameCloseMic"}
    if layout.startswith("PART1"):
        channel = int(layout[-1])
        data = root / NSC_P13 / "PART1" / "DATA" / f"CHANNEL{channel}"
        (data / "WAVE").mkdir(parents=True)
        (data / "SCRIPT").mkdir(parents=True)
        for spk in ("0001", "0002"):
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w") as zf:
                for session in ("0", "1"):
                    rows = []
                    for utt in range(4):
                        audio_id = f"{channel}{spk}{session}{utt:03d}"
                        if not (spk == "0002" and session == "1" and utt == 2):
                            wav = io.BytesIO()
                            write_wav(wav, _sig(rng.uniform(1.0, 2.0), rng.randint(1 << 30)), SR)
                            zf.writestr(f"SPEAKER{spk}/SESSION{session}/{audio_id}.WAV",
                                        wav.getvalue())
                        text = _words(rng, ENGLISH)
                        rows += [f"{audio_id}\t{text.capitalize()}.", f"\t{text}"]
                    (data / "SCRIPT" / f"{channel}{spk}{session}.TXT").write_text(
                        "\ufeff" + "\n".join(rows) + "\n", encoding="utf-8")
            (data / "WAVE" / f"SPEAKER{spk}.zip").write_bytes(buf.getvalue())
        return (root,), {"dataset_part": layout}
    handler = pnsc.get_part_handler_map(root)[layout].script_audio
    audio_dir, script_dir = handler.audio_dir, handler.script_dir
    script_dir.mkdir(parents=True, exist_ok=True)
    if layout == "PART3_SameCloseMic":
        for k in range(4):
            stem = f"conf_{2000 + k}_{2000 + k}"
            seconds = float(rng.uniform(4.0, 6.0))
            _wav(audio_dir / f"{stem}.wav", seconds, 100 + k)
            name = stem if k != 2 else "other-name"
            text = _textgrid({name: _nsc_intervals(rng, seconds)}, seconds + 2.0)
            if k == 1:
                (script_dir / f"{stem}.TextGrid").write_bytes(text.encode("utf-16"))
            else:
                (script_dir / f"{stem}.TextGrid").write_text(text)
        _wav(audio_dir / "conf_2009_2009.wav", 2.0, 109)  # no TextGrid
        _wav(audio_dir / "conf_2010_2010.wav", 2.0, 110)
        (script_dir / "conf_2010_2010.TextGrid").write_bytes(b"ooBinaryFile\x08TextGrid\x00\x01")
    elif layout == "PART3_SeparateIVR":
        for k, session in enumerate(("conf_3001_3002", "conf_3003_3004")):
            for side in range(2):
                stem = f"{session.split('_')[1 + side]}"
                seconds = float(rng.uniform(3.0, 5.0))
                _wav(audio_dir / session / f"{stem}.wav", seconds, 200 + 2 * k + side, sr=8000)
                (script_dir / f"{session}_{stem}.TextGrid").write_text(_textgrid(
                    {f"{session}_{stem}": _nsc_intervals(rng, seconds)}, seconds + 2.0))
    else:
        for k in range(3):
            stem = f"{layout.split('_')[0].lower()}_{k:03d}"
            seconds = float(rng.uniform(3.0, 5.0))
            _wav(audio_dir / f"{stem}.WAV", seconds, 300 + k)
            (script_dir / f"{stem}.TextGrid").write_text(_textgrid(
                {"Speaker": _nsc_intervals(rng, seconds),
                 "Notes": [(0.0, seconds + 2.0, "note")]}, seconds + 2.0))
    return (root,), {"dataset_part": layout}


# -- BABEL -----------------------------------------------------------------------------------


def babel_tree(root, layout="wide", seed=0):
    """``tranche2``: tests/test_recipes_tranche2.py:481 (one training file of
    WAV data behind a ``.sph`` name, empty dev and eval); ``wide``: one
    Cantonese (101) package at 8 kHz, four conversations of 6-8 s per side
    (``inLine``/``outLine``) in training as real SPHERE and WAV, two in dev,
    eval audio with its transcripts withheld; transcripts with noise tags, a
    timestamp line followed by another, and a supervision id written twice;
    ``no-dev``: ``wide`` without dev (eval comes first and has no
    transcript)."""
    if layout == "tranche2":
        stem = "BABEL_BP_101_10033_20111024_205740_inLine"
        conv = root / "conversational"
        _wav(conv / "training" / "audio" / f"{stem}.sph", 3.0, 90)
        tdir = conv / "training" / "transcription"
        tdir.mkdir(parents=True)
        (tdir / f"{stem}.txt").write_text("[0.0]\n<no-speech>\n[0.5]\nhello ((  ))\n[2.0]\n")
        for split in ("dev", "eval"):
            (conv / split / "audio").mkdir(parents=True)
            (conv / split / "transcription").mkdir(parents=True)
        return (root,), {}
    rng = np.random.RandomState(seed)
    conv = root / "IARPA_BABEL_BP_101" / "conversational"
    tags = ("<no-speech>", "<breath>", "<click>", "(())", "<hes>", "<male-to-female> ", "<int>")
    speaker = 10033
    for split, calls in (("training", 4), ("dev", 0 if layout == "no-dev" else 2), ("eval", 2)):
        (conv / split / "audio").mkdir(parents=True, exist_ok=True)
        (conv / split / "transcription").mkdir(parents=True, exist_ok=True)
        for c in range(calls):
            for side in ("inLine", "outLine"):
                speaker += 1
                stem = f"BABEL_BP_101_{speaker}_2011102{c}_2057{c}0_{side}"
                seconds = float(rng.uniform(6.0, 8.0))
                x = _sig(seconds, rng.randint(1 << 30), 8000)
                if side == "inLine":
                    write_sph(str(conv / split / "audio" / f"{stem}.sph"), x, 8000)
                else:
                    write_wav(conv / split / "audio" / f"{stem}.wav", x, 8000)
                if split == "eval":
                    continue
                lines, t = [], 0.0
                while t < seconds + 0.5:
                    lines.append(f"[{t:.3f}]")
                    if rng.rand() < 0.15:
                        lines.append(f"[{t + 0.1:.3f}]")  # a glitch: two stamps in a row
                        t += 0.1
                    lines.append(f"{rng.choice(tags)} {_words(rng, CANTONESE)}")
                    t += float(rng.uniform(0.8, 2.0))
                lines.append(f"[{t:.3f}]")
                (conv / split / "transcription" / f"{stem}.txt").write_text("\n".join(lines) + "\n")
                if split == "training" and c == 0:  # the same ids again, from another file
                    (conv / split / "transcription" / f"{stem}_copy.txt").write_text(
                        "\n".join(lines[:4]) + "\n")
    return (root,), {}


# -- Heroico ---------------------------------------------------------------------------------


def heroico_tree(root, layout="wide", seed=0):
    """``tranche2``: tests/test_recipes_tranche2.py:91; ``tranche13``:
    tests/test_recipes_tranche13.py:20 (an untranscribed answer and a
    malformed USMA speaker); ``wide``: answers of three speakers, recitations
    whose ids cross both bounds of the repeats range (354, 355, 561, 562),
    native and nonnative USMA speakers, Spanish accents in ISO-8859-1,
    answers without a transcript and a non-``sNNN`` USMA file. Returns the
    speech and transcript directories."""
    speech, trans = root / "speech", root / "transcripts"
    trans.mkdir(parents=True, exist_ok=True)
    if layout == "tranche2":
        _wav(speech / "Answers_Spanish" / "1" / "7.wav", seed=7)
        _wav(speech / "Recordings_Spanish" / "1" / "100.wav", seed=8)
        _wav(speech / "Recordings_Spanish" / "1" / "400.wav", seed=9)
        _wav(speech / "usma" / "native-f-maria" / "s3.wav", seed=10)
        (trans / "heroico-answers.txt").write_text("1/7\thola amigo\n", encoding="iso-8859-1")
        (trans / "heroico-recordings.txt").write_text(
            "100\tbuenos dias\n400\trepeticion\n", encoding="iso-8859-1")
        (trans / "usma-prompts.txt").write_text("s3\tcomo estas\n", encoding="iso-8859-1")
        return (speech, trans), {}
    if layout == "tranche13":
        for parts, s in ((("Answers_Spanish", "1", "10"), 0), (("Answers_Spanish", "1", "11"), 1),
                         (("Recordings_Spanish", "2", "100"), 2),
                         (("Recordings_Spanish", "2", "400"), 3),
                         (("usma", "native-f-ana", "s1"), 4), (("usma", "other-speaker", "s1"), 5)):
            path = speech.joinpath(*parts[:-1], f"{parts[-1]}.wav")
            path.parent.mkdir(parents=True, exist_ok=True)
            write_wav(str(path), (0.1 * np.random.RandomState(s).randn(SR // 2)).astype(
                np.float32), SR)
        (trans / "heroico-answers.txt").write_text("1/10\thola mundo\n")
        (trans / "heroico-recordings.txt").write_text("100\tbuenos dias\n400\tfrase repetida\n")
        (trans / "usma-prompts.txt").write_text("s1\tgood morning\n")
        return (speech, trans), {}
    rng = np.random.RandomState(seed)
    answers, recitations, prompts = [], [], []
    for spk in ("1", "2", "3"):
        for pid in range(1, 4):
            _wav(speech / "Answers_Spanish" / spk / f"{pid}.wav", rng.uniform(0.5, 1.5),
                 rng.randint(1 << 30))
            if pid != 3 or spk != "2":  # one answer was never transcribed
                answers.append(f"{spk}/{pid}\t{_words(rng, SPANISH)}")
    for spk in ("4", "5"):
        for pid in (100, 354, 355, 400, 561, 562, 700):
            _wav(speech / "Recordings_Spanish" / spk / f"{pid}.wav", rng.uniform(0.5, 1.5),
                 rng.randint(1 << 30))
    for pid in (100, 354, 355, 400, 561, 562, 700):
        recitations.append(f"{pid}\t{_words(rng, SPANISH)}")
    for spk in ("native-f-ana", "native-m-jose", "nonnative-f-kim", "teacher"):
        for pid in ("s1", "s2", "x3"):
            _wav(speech / "usma" / spk / f"{pid}.wav", rng.uniform(0.5, 1.5), rng.randint(1 << 30))
    prompts += [f"s1\t{_words(rng, SPANISH)}", f"s2\t{_words(rng, SPANISH)}", "# comment"]
    (trans / "heroico-answers.txt").write_text("\n".join(answers) + "\n", encoding="iso-8859-1")
    (trans / "heroico-recordings.txt").write_text(
        "header line\n" + "\n".join(recitations) + "\n", encoding="iso-8859-1")
    (trans / "usma-prompts.txt").write_text("\n".join(prompts) + "\n", encoding="iso-8859-1")
    return (speech, trans), {}


# -- ICMC-ASR --------------------------------------------------------------------------------


def icmcasr_tree(root, layout="wide", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:682 (one train seat,
    an empty dev); ``wide``: two train sections, one dev and one eval_track1
    section, each with four seats of 4-6 s: a headset ``DA0k.wav`` and a
    one-tier ``DA0k.TextGrid`` per seat (empty marks among its intervals;
    one dev seat has no TextGrid) and the four far-field ``DX0kC01.wav``."""
    if layout == "tranche3":
        section = root / "train" / "S01"
        _wav(section / "DA01.wav", 5.0, 59)
        (section / "DA01.TextGrid").write_text(_textgrid(
            {"spk001": [(0.0, 1.0, ""), (1.0, 2.5, "你好 世界")]}, 5))
        (root / "dev").mkdir()
        return (root,), {}
    rng = np.random.RandomState(seed)
    for part, sections in (("train", ("S0001", "S0002")), ("dev", ("S0101",)),
                           ("eval_track1", ("S0201",))):
        for section in sections:
            d = root / part / section
            seconds = float(rng.uniform(4.0, 6.0))
            for k in range(1, 5):
                _wav(d / f"DX0{k}C01.wav", seconds, rng.randint(1 << 30))
                _wav(d / f"DA0{k}.wav", seconds, rng.randint(1 << 30))
                if part == "dev" and k == 4:
                    continue
                intervals, t = [], 0.0
                while t < seconds - 0.6:
                    end = round(min(t + rng.uniform(0.4, 1.5), seconds), 3)
                    text = "" if rng.rand() < 0.3 else _words(rng, MANDARIN, sep="")
                    intervals.append((round(t, 3), end, text))
                    t = end
                (d / f"DA0{k}.TextGrid").write_text(
                    _textgrid({f"{section}-spk{k}": intervals}, seconds))
    return (root,), {}


# -- ReazonSpeech ----------------------------------------------------------------------------


def reazonspeech_tree(root, layout="wide", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:656 (1,105 rows over one
    1 s WAV); ``tranche4``: tests/test_recipes_tranche4.py:178 (five 1 s
    FLAC rows: everything in dev); ``wide``: 1,116 rows over twelve FLAC
    clips of 1-2 s, normalised Japanese texts, so that all three splits
    hold rows."""
    root.mkdir(parents=True, exist_ok=True)
    if layout == "tranche3":
        _wav(root / "u0.wav", seed=58)
        items = [{"id": str(i), "audio_filepath": str(root / "u0.wav"), "text": "こんにちは",
                  "duration": 1.0} for i in range(1105)]
    elif layout == "tranche4":
        items = []
        for i in range(5):
            p = _flac(root / "audio" / f"u{i}.flac", 1.0, 20 + i)
            items.append({"id": f"u{i}", "audio_filepath": str(p), "duration": 1.0,
                          "text": f"こんにちは{i}"})
    else:
        rng = np.random.RandomState(seed)
        clips = []
        for k in range(12):
            seconds = round(float(rng.uniform(1.0, 2.0)), 3)
            clips.append((_flac(root / "audio" / f"{k:03d}.flac", seconds, 500 + k), seconds))
        items = []
        for i in range(1116):
            path, seconds = clips[i % len(clips)]
            items.append({"id": f"{i:06d}", "audio_filepath": str(path), "duration": seconds,
                          "text": jreazon.normalize(_words(rng, JAPANESE, sep=""))})
    (root / "dataset.json").write_text(json.dumps(items, ensure_ascii=False), encoding="utf-8")
    return (root,), {}


# -- Bengali.AI Speech -----------------------------------------------------------------------


def _mp3_available():
    return syscodecs.mp3_available() and syscodecs.mp3_encode_available()


def bengaliai_tree(root, layout="wide", seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:556 (WAV data behind
    ``.mp3`` names: two train clips, one test clip); ``wide``: six
    ``train_mp3s`` clips of 1-2 s as real MP3 (libmp3lame), split train and
    valid by ``train.csv`` (one clip not listed), and two ``test_mp3s``
    clips."""
    if layout == "tranche3":
        _wav(root / "train_mp3s" / "u1.mp3", seed=50)
        _wav(root / "train_mp3s" / "u2.mp3", seed=51)
        _wav(root / "test_mp3s" / "t1.mp3", seed=52)
        (root / "train.csv").write_text(
            "id,sentence,split\nu1,বাংলা বাক্য,train\nu2,অন্য বাক্য,valid\n")
        return (root,), {}
    rng = np.random.RandomState(seed)
    rows = ["id,sentence,split"]
    for part, n in (("train_mp3s", 6), ("test_mp3s", 2)):
        (root / part).mkdir(parents=True, exist_ok=True)
        for k in range(n):
            audio_id = f"{part[:2]}{k:04x}"
            x = _sig(rng.uniform(1.0, 2.0), rng.randint(1 << 30))
            (root / part / f"{audio_id}.mp3").write_bytes(syscodecs.mp3_encode(x, SR))
            if part == "train_mp3s" and k < 5:
                split = "valid" if k % 3 == 2 else "train"
                rows.append(f"{audio_id},{_words(rng, BENGALI)},{split}")
    (root / "train.csv").write_text("\n".join(rows) + "\n")
    return (root,), {}


# -- each recipe against JAX -----------------------------------------------------------------

P = {"ksponspeech": pkspon.prepare_ksponspeech, "nsc": pnsc.prepare_nsc,
     "babel": pbabel.prepare_single_babel_language, "heroico": pheroico.prepare_heroico,
     "icmcasr": picmc.prepare_icmcasr, "reazonspeech": preazon.prepare_reazonspeech,
     "bengaliai_speech": pbengali.prepare_bengaliai_speech}
JP = {"ksponspeech": jkspon.prepare_ksponspeech, "nsc": jnsc.prepare_nsc,
      "babel": jbabel.prepare_single_babel_language, "heroico": jheroico.prepare_heroico,
      "icmcasr": jicmc.prepare_icmcasr, "reazonspeech": jreazon.prepare_reazonspeech,
      "bengaliai_speech": jbengali.prepare_bengaliai_speech}
TREES = {"ksponspeech": ksponspeech_tree, "nsc": nsc_tree, "babel": babel_tree,
         "heroico": heroico_tree, "icmcasr": icmcasr_tree, "reazonspeech": reazonspeech_tree,
         "bengaliai_speech": bengaliai_tree}
CASES = {
    "ksponspeech-tranche3": ("ksponspeech", "tranche3", {}),
    "ksponspeech-tranche4": ("ksponspeech", "tranche4", {}),
    "ksponspeech-wide": ("ksponspeech", "wide", {}),
    "ksponspeech-wide-none": ("ksponspeech", "wide", {"normalize_text": "none"}),
    "ksponspeech-wide-eval": ("ksponspeech", "wide", {"dataset_parts": ["eval_clean",
                                                                        "eval_other"]}),
    "nsc-tranche3": ("nsc", "tranche3", {}),
    "nsc-part1": ("nsc", "PART1_CHANNEL0", {}),
    "nsc-part1-channel2": ("nsc", "PART1_CHANNEL2", {}),
    "nsc-part3": ("nsc", "PART3_SameCloseMic", {}),
    "nsc-part3-ivr": ("nsc", "PART3_SeparateIVR", {}),
    "nsc-part4": ("nsc", "PART4_CodeswitchingDiffRoom", {}),
    "nsc-part5": ("nsc", "PART5_Debate", {}),
    "nsc-part6": ("nsc", "PART6_CallCentreDesign1", {}),
    "babel-tranche2": ("babel", "tranche2", {}),
    "babel-wide": ("babel", "wide", {}),
    "heroico-tranche2": ("heroico", "tranche2", {}),
    "heroico-tranche13": ("heroico", "tranche13", {}),
    "heroico-wide": ("heroico", "wide", {}),
    "icmcasr-tranche3": ("icmcasr", "tranche3", {}),
    "icmcasr-ihm": ("icmcasr", "wide", {}),
    "icmcasr-sdm": ("icmcasr", "wide", {"mic": "sdm"}),
    "icmcasr-mdm": ("icmcasr", "wide", {"mic": "mdm"}),
    "reazonspeech-tranche3": ("reazonspeech", "tranche3", {}),
    "reazonspeech-tranche4": ("reazonspeech", "tranche4", {}),
    "reazonspeech-wide": ("reazonspeech", "wide", {}),
    "bengaliai_speech-tranche3": ("bengaliai_speech", "tranche3", {}),
    "bengaliai_speech-wide": ("bengaliai_speech", "wide", {}),
}


def _prepare(pkg, recipe, args, kwargs, out):
    """One package's ``prepare_*`` after its own ``fix_random_seed(0)``."""
    (fix_random_seed if pkg == "port" else jfix)(0)
    return (P if pkg == "port" else JP)[recipe](*args, output_dir=out, **kwargs)


def _count(made) -> int:
    """The items of every manifest a recipe returned."""
    if isinstance(made, dict):
        return sum(_count(v) for v in made.values())
    return len(list(made))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_equals_jax(tmp_path, case):
    """The returned manifests (paths included) and every file that each
    package's ``prepare_*`` writes on the same layout are equal; JAX runs
    second, so the recipes that convert or unzip into the corpus (KsponSpeech,
    NSC part 1) reuse what the port made."""
    recipe, layout, extra = CASES[case]
    if recipe == "bengaliai_speech" and layout == "wide" and not _mp3_available():
        pytest.skip("the system MP3 libraries are not present")
    args, kwargs = TREES[recipe](tmp_path / "corpus", layout)
    kwargs = {**kwargs, **extra}
    ours = _prepare("port", recipe, args, kwargs, tmp_path / "ours")
    theirs = _prepare("jax", recipe, args, kwargs, tmp_path / "jax")
    assert _dicts(ours) == _dicts(theirs)
    written = _files(tmp_path / "ours")
    assert written and written == _files(tmp_path / "jax")
    assert _count(ours) > 0


# -- what the JAX tests expect, and what the wide layouts hold -----------------------------


def test_ksponspeech_as_the_jax_tests_expect(tmp_path):
    args, kwargs = ksponspeech_tree(tmp_path / "t3", "tranche3")
    m = P["ksponspeech"](*args, output_dir=tmp_path / "out3", **kwargs)
    (sup,) = m["train"]["supervisions"]
    assert sup.text == "안녕 3 하세요" and sup.language == "Korean"
    assert (tmp_path / "t3" / "KsponSpeech_01" / "u1.flac").is_file()
    args, kwargs = ksponspeech_tree(tmp_path / "t4", "tranche4")
    m = P["ksponspeech"](*args, output_dir=tmp_path / "out4", **kwargs)
    (sup,) = m["train"]["supervisions"]
    assert not any(ch in sup.text for ch in "*+/()")
    assert list(m["train"]["recordings"])[0].num_samples == 16000


def test_ksponspeech_wide_parts_and_eval_prefix(tmp_path):
    """All four parts; the eval rows lose their ``KsponSpeech_eval/``
    component; the missing train file is skipped; a cached re-run returns
    the same manifests."""
    args, kwargs = ksponspeech_tree(tmp_path / "corpus")
    m = P["ksponspeech"](*args, output_dir=tmp_path / "out", **kwargs)
    assert {k: len(v["supervisions"]) for k, v in m.items()} == {
        "train": 16, "dev": 4, "eval_clean": 3, "eval_other": 3}
    evals = [r for r in m["eval_clean"]["recordings"]]
    assert all(r.sources[0].source == str(tmp_path / "corpus" / f"{r.id}.flac") for r in evals)
    for sup in (s for part in m.values() for s in part["supervisions"]):
        assert not any(ch in sup.text for ch in "*+/()") and "  " not in sup.text
    again = P["ksponspeech"](*args, output_dir=tmp_path / "out", **kwargs)
    assert _dicts(again) == _dicts(m)


@pytest.mark.parametrize("line", KSPON_LINES)
@pytest.mark.parametrize("mode", ["default", "none"])
def test_ksponspeech_normalize_equals_jax(line, mode):
    assert pkspon.normalize(line, mode) == jkspon.normalize(line, mode)


def test_ksponspeech_flac_round_trip_is_bit_exact(tmp_path):
    """``pcm_to_flac`` of both packages writes the same bytes, the samples
    read back equal the PCM / 32768 bit for bit, and an existing FLAC is
    kept."""
    rng = np.random.RandomState(3)
    pcm = rng.randint(-32768, 32768, size=SR * 2).astype("<i2")
    pcm[:4] = (-32768, 32767, 0, -1)
    pcm.tofile(tmp_path / "u.pcm")
    ours = pkspon.pcm_to_flac(tmp_path / "u.pcm", tmp_path / "port.flac")
    theirs = jkspon.pcm_to_flac(tmp_path / "u.pcm", tmp_path / "jax.flac")
    assert ours.read_bytes() == theirs.read_bytes()
    from lhotse_tpu_torch.audio import Recording

    samples = Recording.from_file(ours).load_audio()
    assert samples.dtype == np.float32
    assert np.array_equal(samples[0], pcm.astype(np.float32) / 32768.0)
    before = ours.stat().st_mtime_ns
    pkspon.pcm_to_flac(tmp_path / "u.pcm", ours)
    assert ours.stat().st_mtime_ns == before


def test_nsc_as_the_jax_test_expects(tmp_path):
    args, kwargs = nsc_tree(tmp_path / "corpus", "tranche3")
    m = P["nsc"](*args, output_dir=tmp_path / "out", **kwargs)
    (sup,) = m["supervisions"]
    assert sup.text == "lah okay can" and sup.language == "Singaporean English"
    assert sup.recording_id == "PART3_SameCloseMic_conf_0001"


def test_nsc_part3_skips_what_jax_skips(tmp_path):
    """The binary TextGrid, the tier of another name and the audio without a
    TextGrid lose their recordings (each logged); ``<S>``/``<Z>`` intervals
    are dropped; the interval past the end is clipped, the one after it
    dropped; the utf-16 TextGrid is read."""
    args, kwargs = nsc_tree(tmp_path / "corpus", "PART3_SameCloseMic")
    m = P["nsc"](*args, **kwargs)
    recs = {r.id: r for r in m["recordings"]}
    assert sorted(recs) == [f"PART3_SameCloseMic_conf_{k}_{k}" for k in (2000, 2001, 2003)]
    sups = list(m["supervisions"])
    assert not {"<S>", "<Z>", "after the end"} & {s.text for s in sups}
    for s in sups:
        assert 0 < s.duration and s.end <= recs[s.recording_id].duration + 1e-9
    assert sum(s.text == "past the end" for s in sups) == 3


def test_nsc_part1_unzips_once_and_reuses(tmp_path, caplog):
    """Part 1 extracts each speaker zip into ``WAVE/extracted`` and reuses
    it on the next run (with a warning); the session without one WAV keeps
    its other utterances; each text is the script's second row."""
    args, kwargs = nsc_tree(tmp_path / "corpus", "PART1_CHANNEL0")
    first = P["nsc"](*args, **kwargs)
    extracted = (tmp_path / "corpus" / NSC_P13 / "PART1" / "DATA" / "CHANNEL0" / "WAVE"
                 / "extracted")
    assert sorted(p.name for p in extracted.iterdir()) == ["SPEAKER0001", "SPEAKER0002"]
    with caplog.at_level("WARNING"):
        second = P["nsc"](*args, **kwargs)
    assert "Reusing" in caplog.text
    assert _dicts(first) == _dicts(second)
    assert len(first["recordings"]) == 15 and "000021002" not in {r.id for r in first["recordings"]}
    assert all(s.text == s.text.lower() and not s.text.endswith(".") for s in first["supervisions"])


def test_nsc_refusals_equal_jax(tmp_path):
    """``PART3_SameBoundaryMic`` is refused by an assertion and an unknown
    part by ``ValueError``, in both packages."""
    args, _ = nsc_tree(tmp_path / "corpus", "PART3_SameCloseMic")
    for prepare in (P["nsc"], JP["nsc"]):
        with pytest.raises(AssertionError, match="not supported"):
            prepare(*args, dataset_part="PART3_SameBoundaryMic")
        with pytest.raises(ValueError, match="Unknown dataset part"):
            prepare(*args, dataset_part="PART7")


def test_nsc_handler_map_equals_jax(tmp_path):
    ours, theirs = pnsc.get_part_handler_map(tmp_path), jnsc.get_part_handler_map(tmp_path)
    assert list(ours) == list(theirs) == pnsc.NSC_PARTS
    for part in ours:
        assert ours[part].handler.__name__ == theirs[part].handler.__name__
        assert (ours[part].script_audio.script_dir, ours[part].script_audio.audio_dir) == (
            theirs[part].script_audio.script_dir, theirs[part].script_audio.audio_dir)


def test_babel_as_the_jax_test_expects(tmp_path):
    args, _ = babel_tree(tmp_path / "corpus", "tranche2")
    m = P["babel"](*args, output_dir=tmp_path / "out")
    sups = sorted(m["training"]["supervisions"], key=lambda s: s.start)
    assert len(sups) == 2 and sups[0].text == "<silence>"
    assert sups[1].language == "Cantonese" and sups[1].speaker == "101_10033_A"


def test_babel_keeps_withheld_eval_recordings(tmp_path):
    """Eval has audio and no transcript: its recordings are kept with no
    supervision; dev and training keep only what the transcripts cover."""
    args, _ = babel_tree(tmp_path / "corpus")
    m = P["babel"](*args, output_dir=tmp_path / "out")
    assert sorted(m) == ["dev", "eval", "training"]
    assert len(m["eval"]["recordings"]) == 4 and len(m["eval"]["supervisions"]) == 0
    assert {r.sampling_rate for part in m.values() for r in part["recordings"]} == {8000}
    assert len(m["training"]["recordings"]) == 8
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        f"babel-Cantonese_{kind}_{tag}.jsonl.gz" for kind in ("recordings", "supervisions")
        for tag in ("dev", "eval", "train"))


def test_babel_language_without_a_transcript_where_jax_raises(tmp_path):
    """ROADMAP C2: with no dev split, the eval split (audio, no transcript)
    comes before any transcript, and the JAX package names its files by
    ``BABELCODE2LANG[None]``: ``KeyError``. The port takes the language code
    from the audio files' names and writes what JAX writes for the layout
    with dev."""
    args, _ = babel_tree(tmp_path / "corpus", "no-dev")
    with pytest.raises(KeyError):
        JP["babel"](*args, output_dir=tmp_path / "jax")
    m = P["babel"](*args, output_dir=tmp_path / "ours")
    assert sorted(m) == ["eval", "training"] and len(m["eval"]["recordings"]) == 4
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == sorted(
        f"babel-Cantonese_{kind}_{tag}.jsonl.gz" for kind in ("recordings", "supervisions")
        for tag in ("eval", "train"))
    assert _dicts(m) == _dicts(JP["babel"](*args))  # without output_dir JAX does not raise


@pytest.mark.parametrize("text", [
    "<no-speech>", "hello ((  )) <hes> world", "<breath> <lipsmack> <cough>",
    "<click> <ring> <dtmf> <int> <sta>", "<male-to-female> hi", "(()) <foreign> <overlap>"])
def test_babel_normalize_text_equals_jax(text):
    assert pbabel.normalize_text(text) == jbabel.normalize_text(text)


def test_babel_transcript_segments_equal_jax(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("[0.0]\n[0.2]\na\n[1.5]\nb\n[2.0]\n[2.5]\n[3.0]\nc\n")
    assert list(pbabel._transcript_segments(p)) == list(jbabel._transcript_segments(p))


def test_heroico_as_the_jax_tests_expect(tmp_path):
    args, _ = heroico_tree(tmp_path / "t2", "tranche2")
    m = P["heroico"](*args, output_dir=tmp_path / "out2")
    assert {s.text for s in m["train"]["supervisions"]} == {"hola amigo", "buenos dias"}
    assert [s.text for s in m["devtest"]["supervisions"]] == ["repeticion"]
    assert [s.text for s in m["test"]["supervisions"]] == ["como estas"]
    args, _ = heroico_tree(tmp_path / "t13", "tranche13")
    m = P["heroico"](*args, output_dir=tmp_path / "out13")
    assert sorted(s.id for s in m["train"]["supervisions"]) == [
        "answers-1-10", "heroico-recitations-2-100"]
    assert [s.id for s in m["devtest"]["supervisions"]] == ["heroico-recitations-repeats-2-400"]
    assert [s.id for s in m["test"]["supervisions"]] == ["usma-native-f-ana-s1"]


def test_heroico_folds(tmp_path):
    """Recitations 355-561 go to devtest, 354 and 562 to train; USMA keeps
    native and nonnative speakers and ``sNNN`` files only; the untranscribed
    answer is dropped; accents come through ISO-8859-1."""
    args, _ = heroico_tree(tmp_path / "corpus")
    m = P["heroico"](*args)
    ids = {fold: sorted(s.id for s in m[fold]["supervisions"]) for fold in m}
    assert len(ids["train"]) == 8 + 2 * 4 and "answers-2-3" not in ids["train"]
    assert ids["devtest"] == sorted(f"heroico-recitations-repeats-{spk}-{pid}"
                                    for spk in "45" for pid in (355, 400, 561))
    assert ids["test"] == sorted(f"usma-{spk}-{pid}" for spk in (
        "native-f-ana", "native-m-jose", "nonnative-f-kim") for pid in ("s1", "s2"))
    texts = {s.text for fold in m.values() for s in fold["supervisions"]}
    assert any(ch in t for t in texts for ch in "áéíóúñ")


def test_heroico_where_a_parent_directory_names_a_subcorpus(tmp_path):
    """ROADMAP C2: the JAX package sorts a wav by substrings of its whole
    path, so a corpus under a directory whose name holds ``usma`` sends every
    recitation to the USMA branch, where it is dropped. The port sorts by the
    directories below ``speech_dir`` and makes what JAX makes elsewhere."""
    args, _ = heroico_tree(tmp_path / "usma_mirror" / "corpus")
    ours, theirs = P["heroico"](*args), JP["heroico"](*args)
    assert "devtest" not in theirs
    assert not any("recitations" in s.id for s in theirs["train"]["supervisions"])
    args_elsewhere, _ = heroico_tree(tmp_path / "elsewhere" / "corpus")
    elsewhere = JP["heroico"](*args_elsewhere)
    relative = str(tmp_path / "usma_mirror"), str(tmp_path / "elsewhere")
    assert json.dumps(_dicts(ours)).replace(*relative) == json.dumps(_dicts(elsewhere))


def test_icmcasr_as_the_jax_test_expects(tmp_path):
    args, _ = icmcasr_tree(tmp_path / "corpus", "tranche3")
    m = P["icmcasr"](*args, output_dir=tmp_path / "out", mic="ihm")
    (sup,) = m["train"]["supervisions"]
    assert sup.speaker == "spk001" and sup.start == 1.0 and sup.duration == 1.5
    assert "你好" in sup.text
    again = P["icmcasr"](*args, output_dir=tmp_path / "out", mic="ihm")
    assert len(list(again["train"]["supervisions"])) == 1


def test_icmcasr_mic_setups(tmp_path):
    """``ihm`` prepares train and dev; ``sdm`` and ``mdm`` eval_track1 too;
    ``sdm`` makes each seat's segments once per DX channel; ``mdm`` makes a
    four-source recording per seat whose segments name channels 0-3, and
    its audio is the four DX files stacked."""
    args, _ = icmcasr_tree(tmp_path / "corpus")
    ihm, sdm, mdm = (P["icmcasr"](*args, mic=mic) for mic in ("ihm", "sdm", "mdm"))
    assert sorted(ihm) == ["dev", "train"] and sorted(sdm) == sorted(mdm) == [
        "dev", "eval_track1", "train"]
    for part in ("train", "dev"):
        assert len(sdm[part]["supervisions"]) == 4 * len(ihm[part]["supervisions"])
        assert len(mdm[part]["supervisions"]) == len(ihm[part]["supervisions"])
    assert len(ihm["dev"]["recordings"]) == 3
    rec = mdm["train"]["recordings"]["train-S0001-DXmixC01-DA01"]
    assert rec.num_channels == 4 and rec.sampling_rate == SR
    from lhotse_tpu_torch.audio import Recording

    stacked = np.concatenate([
        Recording.from_file(tmp_path / "corpus" / "train" / "S0001" / f"DX0{k}C01.wav")
        .load_audio() for k in range(1, 5)])
    assert np.array_equal(rec.load_audio(), stacked)
    assert all(s.channel == [0, 1, 2, 3] for s in mdm["train"]["supervisions"])


def test_icmcasr_refuses_two_tiers_as_jax(tmp_path):
    args, _ = icmcasr_tree(tmp_path / "corpus", "tranche3")
    (tmp_path / "corpus" / "train" / "S01" / "DA01.TextGrid").write_text(_textgrid(
        {"a": [(0.0, 1.0, "x")], "b": [(0.0, 1.0, "y")]}, 5))
    for prepare in (P["icmcasr"], JP["icmcasr"]):
        with pytest.raises(AssertionError, match="Expected 1 tier"):
            prepare(*args)


JA_NUMBERS = ("0", "10", "11", "100", "1000", "10000", "100000000", "123456789", "3.14", "5.",
              "20", "101", "1001", "10001", "1234567890123", "0.5")


@pytest.mark.parametrize("number", JA_NUMBERS)
def test_ja_number_equals_jax(number):
    assert preazon._ja_number(number) == jreazon._ja_number(number)


def test_reazonspeech_normalize_equals_jax():
    for text in ("１２３、こんにちは。", "ＡＢＣは3.5と5.です！", "「今日」は『いい』天気？",
                 "100000000円", "ｚｅｎｋａｋｕ０９"):
        assert preazon.normalize(text) == jreazon.normalize(text)
    assert preazon.normalize("１２３、こんにちは。").startswith("百二十三")


def test_reazonspeech_splits_and_cached_rerun(tmp_path):
    """1,116 rows: dev the first 1,000, test the next 100, train the last
    16, and the three ``.json`` splits written into the corpus; a cached
    re-run returns the cuts as well, equal to JAX's cached re-run."""
    args, _ = reazonspeech_tree(tmp_path / "corpus")
    m = P["reazonspeech"](*args, output_dir=tmp_path / "ours")
    assert {part: len(list(v["cuts"])) for part, v in m.items()} == {
        "train": 16, "dev": 1000, "test": 100}
    for part, first in (("dev", 0), ("test", 1000), ("train", 1100)):
        rows = json.loads((tmp_path / "corpus" / f"{part}.json").read_text(encoding="utf-8"))
        assert rows[0]["id"] == f"{first:06d}"
    ours = P["reazonspeech"](*args, output_dir=tmp_path / "ours")
    JP["reazonspeech"](*args, output_dir=tmp_path / "jax")
    theirs = JP["reazonspeech"](*args, output_dir=tmp_path / "jax")
    assert _dicts(ours) == _dicts(theirs) == _dicts(m)


def test_reazonspeech_at_two_jobs_equals_one(tmp_path):
    """``num_jobs=2`` parses the rows in spawned workers, in order."""
    args, _ = reazonspeech_tree(tmp_path / "corpus", "tranche4")
    one = P["reazonspeech"](*args, output_dir=tmp_path / "one")
    two = P["reazonspeech"](*args, output_dir=tmp_path / "two", num_jobs=2)
    assert _dicts(one) == _dicts(two)


def test_bengaliai_speech_as_the_jax_test_expects(tmp_path):
    args, _ = bengaliai_tree(tmp_path / "corpus", "tranche3")
    m = P["bengaliai_speech"](*args, output_dir=tmp_path / "out")
    assert [s.text for s in m["train"]["supervisions"]] == ["বাংলা বাক্য"]
    assert [s.text for s in m["valid"]["supervisions"]] == ["অন্য বাক্য"]
    (test_sup,) = m["test"]["supervisions"]
    assert test_sup.text is None
    again = P["bengaliai_speech"](*args, output_dir=tmp_path / "out")
    assert [s.text for s in again["train"]["supervisions"]] == ["বাংলা বাক্য"]


@pytest.mark.skipif(not _mp3_available(), reason="the system MP3 libraries are not present")
def test_bengaliai_speech_mp3_splits(tmp_path):
    """Real MP3: the unlisted clip is in no split, test clips have no text,
    and the decoded length matches the recording's."""
    args, _ = bengaliai_tree(tmp_path / "corpus")
    m = P["bengaliai_speech"](*args)
    sizes = {part: len(v["recordings"]) for part, v in m.items()}
    assert sizes == {"train": 4, "valid": 1, "test": 2}
    for part in m.values():
        for r in part["recordings"]:
            assert r.load_audio().shape == (1, r.num_samples)
    assert all(s.text is None for s in m["test"]["supervisions"])


def test_downloads_are_left_out():
    """The port defines none of the JAX modules' downloads, and its modules
    import no network library."""
    for module, jax_module, name in ((pheroico, jheroico, "download_heroico"),
                                     (preazon, jreazon, "download_reazonspeech")):
        assert hasattr(jax_module, name) and not hasattr(module, name)
    for module in (pkspon, pnsc, pbabel, pheroico, picmc, preazon, pbengali):
        source = open(module.__file__).read()
        assert "urllib" not in source and "requests" not in source
        assert "resumable_download" not in source and "load_dataset" not in source


# -- the prepare commands --------------------------------------------------------------------

COMMANDS = {
    # command: (argv from (args, kwargs) of the layout, the layout maker, the function's call)
    "ksponspeech": (lambda a, k: ["ksponspeech", a[0], "{out}", "-p", "train", "-p", "dev",
                                  "--normalize-text", "none"],
                    lambda r: ksponspeech_tree(r),
                    lambda a, k, o: P["ksponspeech"](a[0], dataset_parts=["train", "dev"],
                                                     output_dir=o, normalize_text="none")),
    "ksponspeech-all": (lambda a, k: ["ksponspeech", a[0], "{out}"],
                        lambda r: ksponspeech_tree(r),
                        lambda a, k, o: P["ksponspeech"](a[0], output_dir=o)),
    "nsc": (lambda a, k: ["nsc", a[0], "{out}", "-p", "PART6_CallCentreDesign1"],
            lambda r: nsc_tree(r, "PART6_CallCentreDesign1"),
            lambda a, k, o: P["nsc"](a[0], dataset_part="PART6_CallCentreDesign1",
                                     output_dir=o)),
    "nsc-default": (lambda a, k: ["nsc", a[0], "{out}"],
                    lambda r: nsc_tree(r, "PART3_SameCloseMic"),
                    lambda a, k, o: P["nsc"](a[0], output_dir=o)),
    "babel": (lambda a, k: ["babel", a[0], "{out}"], lambda r: babel_tree(r),
              lambda a, k, o: P["babel"](a[0], output_dir=o)),
    "heroico": (lambda a, k: ["heroico", a[0], a[1], "{out}"], lambda r: heroico_tree(r),
                lambda a, k, o: P["heroico"](a[0], a[1], output_dir=o)),
    "icmcasr": (lambda a, k: ["icmcasr", a[0], "{out}", "--mic", "mdm"],
                lambda r: icmcasr_tree(r),
                lambda a, k, o: P["icmcasr"](a[0], output_dir=o, mic="mdm")),
    "reazonspeech": (lambda a, k: ["reazonspeech", a[0], "{out}", "-j", "1"],
                     lambda r: reazonspeech_tree(r, "tranche4"),
                     lambda a, k, o: P["reazonspeech"](a[0], output_dir=o)),
    "bengaliai-speech": (lambda a, k: ["bengaliai-speech", a[0], "{out}"],
                         lambda r: bengaliai_tree(r, "tranche3"),
                         lambda a, k, o: P["bengaliai_speech"](a[0], output_dir=o)),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_prepare_command_writes_what_its_function_writes(tmp_path, name):
    """Each ``prepare`` command writes the files its function writes, and
    the JAX CLI's command the same, with the output directory replaced."""
    from test_torch_cli import _both as both_clis

    argv, build, function = COMMANDS[name]
    args, kwargs = build(tmp_path / "corpus")
    runs = both_clis(tmp_path, "prepare", *argv(args, kwargs))
    function(args, kwargs, tmp_path / "function")
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    ours = _files(pout)
    assert ours and ours == _files(tmp_path / "function") == _files(jout)


# -- the slice: KsponSpeech into the on-device chain, ICMC-ASR's array channels -------------


@pytest.fixture(scope="module")
def kspon_slice(tmp_path_factory):
    root = tmp_path_factory.mktemp("kspon_slice")
    args, kwargs = ksponspeech_tree(root / "corpus")
    made = {}
    for pkg, CS in (("port", CutSet), ("jax", J.CutSet)):
        m = _prepare(pkg, "ksponspeech", args, {**kwargs, "dataset_parts": "train"}, root / pkg)
        made[pkg] = CS.from_manifests(recordings=m["train"]["recordings"],
                                      supervisions=m["train"]["supervisions"]).to_eager()
    return root, list(made["port"]), list(made["jax"])


def test_ksponspeech_utterances_through_the_augmenter_equal_jax(kspon_slice):
    """The first 12 KsponSpeech train utterances (1-3 s), in batches of the
    3 s x 4 bucket through each package's augmenter with the same MUSAN
    noise pool and real RIR, speed 1.1, SNR (10, 20) and SpecAugment: the
    port within ``AUG_TOL`` of the JAX augmenter whose fbank stage is its
    kernel route in float64."""
    root, ours, theirs = kspon_slice
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


def test_icmcasr_mdm_audio_equals_jax(tmp_path):
    """Each ``mdm`` recording loads as (4, T) in both packages, equal, and
    its segments trimmed with every channel kept load the same windows."""
    args, _ = icmcasr_tree(tmp_path / "corpus")
    ours, theirs = P["icmcasr"](*args, mic="mdm"), JP["icmcasr"](*args, mic="mdm")
    for r, jr in zip(ours["dev"]["recordings"], theirs["dev"]["recordings"]):
        audio = r.load_audio()
        assert audio.shape == (4, r.num_samples) and np.array_equal(audio, jr.load_audio())
    cuts = CutSet.from_manifests(recordings=ours["train"]["recordings"],
                                 supervisions=ours["train"]["supervisions"]).trim_to_supervisions(
        keep_overlapping=False, keep_all_channels=True).to_eager()
    jcuts = J.CutSet.from_manifests(
        recordings=theirs["train"]["recordings"], supervisions=theirs["train"]["supervisions"]
    ).trim_to_supervisions(keep_overlapping=False, keep_all_channels=True).to_eager()
    assert len(cuts) == len(ours["train"]["supervisions"]) > 0
    for c, jc in list(zip(cuts, jcuts))[:6]:
        assert c.num_channels == 4 and np.array_equal(c.load_audio(), jc.load_audio())
