"""
The port's Chinese corpus recipes (lhotse_tpu_torch.recipes ``thchs_30``,
``stcmds``, ``primewords``, ``magicdata``, ``aidatatang_200zh``,
``tal_asr``, ``tal_csasr``, ``cdsd``, ``kespeech``, ``aishell3``,
``baker_zh``, ``wenetspeech4tts``, ``speechio``, ``xbmu_amdo31`` and
``mdcc``) against the JAX package's, on the fixture layouts of
tests/test_recipes.py:381, tests/test_recipes_tranche4.py:25-103,
tests/test_recipes_tranche2.py (AISHELL-3, MDCC) and
tests/test_recipes_tranche3.py (made from a numpy seed) and on wider
layouts of the same formats; their text normalizers on the JAX tests'
strings; their ``prepare`` commands through both CLIs; and the slice as a
whole at a small size: a THCHS-30, MagicData and KeSpeech mux of 8
utterances (``CutSet.mux``, the same seed in each package) at a 2 s x 4
bucket with an int16 wire into each package's ``OnDeviceAugmenter`` with
the same MUSAN noise pool, real RIR and seed: within 1e-4, the bound of
tests/test_torch_recipes_asr.py, of the JAX augmenter with the JAX fbank
layer's kernel route evaluated in float64 (the float32 routes part by more
in near-silent low mel bins; ``test_zh_mux_fed_augmenter_equals_jax``
gives the numbers); and the same mux through
``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures``: within
``EXTRACTOR_TOL`` of the JAX chain with its extractor's device route.

Written ``.jsonl.gz`` manifests are compared after decompression, since a
gzip header carries its write time.
"""
import json

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import aidatatang_200zh as jaidatatang
from lhotse_tpu.recipes import aishell3 as jaishell3
from lhotse_tpu.recipes import baker_zh as jbaker
from lhotse_tpu.recipes import cdsd as jcdsd
from lhotse_tpu.recipes import kespeech as jkespeech
from lhotse_tpu.recipes import magicdata as jmagicdata
from lhotse_tpu.recipes import mdcc as jmdcc
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import primewords as jprimewords
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.recipes import speechio as jspeechio
from lhotse_tpu.recipes import stcmds as jstcmds
from lhotse_tpu.recipes import tal_asr as jtal_asr
from lhotse_tpu.recipes import tal_csasr as jtal_csasr
from lhotse_tpu.recipes import thchs_30 as jthchs
from lhotse_tpu.recipes import wenetspeech4tts as jwenet4tts
from lhotse_tpu.recipes import xbmu_amdo31 as jxbmu
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import _zh_common as pzh_common
from lhotse_tpu_torch.recipes import aidatatang_200zh as paidatatang
from lhotse_tpu_torch.recipes import aishell3 as paishell3
from lhotse_tpu_torch.recipes import baker_zh as pbaker
from lhotse_tpu_torch.recipes import cdsd as pcdsd
from lhotse_tpu_torch.recipes import kespeech as pkespeech
from lhotse_tpu_torch.recipes import magicdata as pmagicdata
from lhotse_tpu_torch.recipes import mdcc as pmdcc
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import primewords as pprimewords
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.recipes import speechio as pspeechio
from lhotse_tpu_torch.recipes import stcmds as pstcmds
from lhotse_tpu_torch.recipes import tal_asr as ptal_asr
from lhotse_tpu_torch.recipes import tal_csasr as ptal_csasr
from lhotse_tpu_torch.recipes import thchs_30 as pthchs
from lhotse_tpu_torch.recipes import wenetspeech4tts as pwenet4tts
from lhotse_tpu_torch.recipes import xbmu_amdo31 as pxbmu
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_device_augment import _JaxKernelRoute
from test_torch_recipes_asr import _both, _dicts, _wav
from test_torch_recipes_noise import (
    AUG_TOL, EXTRACTOR_TOL, musan_tree, noise_pool, rir_noise_tree, seeded_rir)

SR = 16000
MANDARIN = ("甚至", "出现", "交易", "几乎", "停滞", "的", "情况", "一二线", "城市")


def _burst(path, rng, seconds, sr=SR, f0=150.0):
    """A tone burst under white noise, as the slice layouts write it."""
    path.parent.mkdir(parents=True, exist_ok=True)
    m = int(seconds * sr)
    t = np.arange(m) / sr
    x = 0.2 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.randn(m)
    write_wav(path, x[None].astype(np.float32), sr)


def _text(rng, lo=3, hi=7, sep=" "):
    return sep.join(MANDARIN[i] for i in rng.randint(0, len(MANDARIN), rng.randint(lo, hi)))


# -- the JAX tests' layouts, and wider ones of the same formats --------------------------


def stcmds_tree(root, layout="recipes"):
    """``recipes``: tests/test_recipes.py:387; ``tranche4``:
    tests/test_recipes_tranche4.py:84 (no trailing newline); ``wide``: two
    speakers of two utterances and a WAV file without a transcript."""
    st = root / "ST-CMDS-20170001_1-OS"
    st.mkdir(parents=True, exist_ok=True)
    if layout in ("recipes", "tranche4"):
        utt = "20170001P00001A0001"
        _wav(st / f"{utt}.wav", seed=60 if layout == "recipes" else 7)
        (st / f"{utt}.txt").write_text(
            "你好，世界\n" if layout == "recipes" else "你好，世界", encoding="utf-8")
        return root
    for i, utt in enumerate(["20170001P00001A0001", "20170001P00001A0002",
                             "20170001P00007I0001", "20170001P00007I0002"]):
        _wav(st / f"{utt}.wav", seed=70 + i)
        (st / f"{utt}.txt").write_text(f"第{i}句，ｎｉ hao\n", encoding="utf-8")
    _wav(st / "20170001P00009A0001.wav", seed=79)
    return root


def thchs_tree(root, layout="recipes", n=3, seed=0):
    """``recipes``: tests/test_recipes.py:396 (a ``.wav.trn`` per split);
    ``tranche4``: tests/test_recipes_tranche4.py:97 (train only, dev and
    test absent); ``slice``: ``n`` tone bursts of 1.2-2 s over the three
    splits, their transcripts with the `` l =`` marker."""
    th = root / "data_thchs30"
    (th / "data").mkdir(parents=True, exist_ok=True)
    if layout == "recipes":
        for part, utt in (("train", "A11_0"), ("dev", "A11_1"), ("test", "A11_2")):
            (th / part).mkdir(exist_ok=True)
            _wav(th / part / f"{utt}.wav", seed=61)
            (th / "data" / f"{utt}.wav.trn").write_text("绿 是 阳春\nlv4 shi4\nl v4\n")
    elif layout == "tranche4":
        _wav(th / "data" / "B11_374.wav", seed=8)
        (th / "data" / "B11_374.wav.trn").write_text(
            "绿 是 阳春 烟 景\nlv4 shi4 ...\nl v4 ...\n", encoding="utf-8")
        _wav(th / "train" / "B11_374.wav", seed=8)
    else:
        rng = np.random.RandomState(seed)
        for i in range(n):
            part = ("train", "dev", "test")[i % 3]
            utt = f"{'ABCD'[i % 4]}{11 + i // 4}_{100 + i}"
            _burst(th / "data" / f"{utt}.wav", rng, rng.uniform(1.2, 2.0), f0=140 + 25 * i)
            (th / part).mkdir(exist_ok=True)
            (th / part / f"{utt}.wav").write_bytes((th / "data" / f"{utt}.wav").read_bytes())
            (th / "data" / f"{utt}.wav.trn").write_text(
                f"{_text(rng)} l =\npin1 yin1\np in1\n", encoding="utf-8")
    return root


def magicdata_tree(root, layout="recipes", n=3, seed=0):
    """``recipes``: tests/test_recipes.py:406 (tab-separated tables, a
    ``[FIL]`` token); ``tranche4``: tests/test_recipes_tranche4.py:44
    (space-separated, no test split); ``slice``: ``n`` tone bursts of
    1.2-2 s over the three splits, with punctuation and noise tokens."""
    if layout == "recipes":
        for part, utt in (("train", "utt_001"), ("dev", "utt_002"), ("test", "utt_003")):
            (root / part / "SPK01").mkdir(parents=True)
            _wav(root / part / "SPK01" / f"{utt}.wav", seed=62)
            (root / part / "TRANS.txt").write_text(
                "UtteranceID\tSpeakerID\tTranscription\n"
                f"{utt}.wav\tSPK01\t你好！世界[FIL]\n")
    elif layout == "tranche4":
        for part, utt, spk, seed_ in (("train", "A_1", "SPK1", 3), ("dev", "B_2", "SPK2", 4)):
            _wav(root / part / spk / f"{utt}.wav", seed=seed_)
            (root / part / "TRANS.txt").write_text(
                "UtteranceID SpeakerID Transcription\n"
                f"{utt}.wav {spk} 你好，世界！\n", encoding="utf-8")
    else:
        rng = np.random.RandomState(seed)
        lines = {}
        for i in range(n):
            part = ("train", "dev", "test")[i % 3]
            spk = f"{38 + i % 2}_{5700 + i % 2}"
            utt = f"{spk}_{20170915170000 + i}"
            _burst(root / part / spk / f"{utt}.wav", rng, rng.uniform(1.2, 2.0), f0=310 + 25 * i)
            lines.setdefault(part, ["UtteranceID\tSpeakerID\tTranscription"]).append(
                f"{utt}.wav\t{spk}\t{_text(rng)}，[SPK]《好》")
        for part, rows in lines.items():
            (root / part / "TRANS.txt").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return root


def primewords_tree(root, layout="recipes"):
    """``recipes``: tests/test_recipes.py:418; ``tranche4``:
    tests/test_recipes_tranche4.py:65 (two speakers); both under
    ``primewords_md_2018_set1``."""
    pw = root / "primewords_md_2018_set1"
    pw.mkdir(parents=True, exist_ok=True)
    if layout == "recipes":
        _wav(pw / "audio_files" / "0" / "00" / "abc123.wav", seed=63)
        table = [{"file": "abc123.wav", "text": "早上好", "user_id": 42}]
    else:
        table = [{"file": "a1.wav", "text": "第 一 句", "user_id": 100},
                 {"file": "b2.wav", "text": "第 二 句", "user_id": 200}]
        _wav(pw / "audio_files" / "0" / "00" / "a1.wav", seed=5)
        _wav(pw / "audio_files" / "1" / "11" / "b2.wav", seed=6)
    (pw / "set1_transcript.json").write_text(json.dumps(table), encoding="utf-8")
    return root


def aidatatang_tree(root, layout="recipes"):
    """``recipes``: tests/test_recipes.py:430 (fullwidth letters, the three
    splits); ``tranche4``: tests/test_recipes_tranche4.py:25 (train and
    dev only)."""
    d = root / "aidatatang_200zh"
    (d / "transcript").mkdir(parents=True, exist_ok=True)
    if layout == "recipes":
        text = "T0055G0001S0001 ｔｅＡ 早上 好\nT0055G0001S0002 下午 好\nT0055G0001S0003 晚上 好\n"
        for part, utt in (("train", "S0001"), ("dev", "S0002"), ("test", "S0003")):
            _wav(d / "corpus" / part / "G0001" / f"T0055G0001{utt}.wav", seed=64)
    else:
        text = "T0055G0013S0001 你好Ａ世界\nT0055G0036S0002 测试 abc\n"
        _wav(d / "corpus" / "train" / "G0013" / "T0055G0013S0001.wav", seed=1)
        _wav(d / "corpus" / "dev" / "G0036" / "T0055G0036S0002.wav", seed=2)
    (d / "transcript" / "aidatatang_200_zh_transcript.txt").write_text(text, encoding="utf-8")
    return root


def tal_asr_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:35 (no test split);
    ``full``: every split, a WAV file without a transcript."""
    base = root / "aisolution_data"
    _wav(base / "wav" / "train" / "spkA" / "utt001.wav", seed=3)
    _wav(base / "wav" / "dev" / "spkB" / "utt002.wav", seed=4)
    lines = "utt001 你好，世界。\nutt002 Ａpple#测试\n"
    if layout == "full":
        _wav(base / "wav" / "test" / "spkC" / "utt003.wav", seed=14)
        _wav(base / "wav" / "train" / "spkA" / "utt009.wav", seed=15)
        lines += "utt003 上课=了|、同学们？\n"
    (base / "transcript").mkdir(parents=True, exist_ok=True)
    (base / "transcript" / "transcript.txt").write_text(lines, encoding="utf-8")
    return root


def tal_csasr_tree(root):
    """tests/test_recipes_tranche3.py:53."""
    base = root / "TALCS_corpus"
    for part, seed in (("train_set", 5), ("dev_set", 6), ("test_set", 7)):
        _wav(base / part / "wav" / f"u{seed}.wav", seed=seed)
        (base / part / "label.txt").write_text(f"u{seed} 上面是 ＨＩ world！\n", encoding="utf-8")
    return root


def cdsd_tree(root):
    """tests/test_recipes_tranche3.py:67."""
    base = root / "after_catting"
    _wav(base / "1h" / "Audio" / "S01" / "utt1.wav", seed=8)
    (base / "1h" / "Text").mkdir(parents=True)
    (base / "1h" / "Text" / "S01.txt").write_text("utt1 你 好 ｔest\n", encoding="utf-8")
    _wav(base / "10h" / "Audio" / "S02" / "utt2.wav", seed=9)
    (base / "10h" / "Text").mkdir(parents=True)
    (base / "10h" / "Text" / "S02.txt").write_text("utt2 再 见\n", encoding="utf-8")
    return root


def speechio_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:84; ``two_sets``: a
    second test set whose metadata lists a missing file (skipped)."""
    part = root / "SPEECHIO_ASR_ZH00000"
    _wav(part / "wavs" / "a_0001.wav", seed=10)
    (part / "metadata.tsv").write_text(
        "ID\tAUDIO\tTEXT\na_0001\twavs/a_0001.wav\t测试文本\n", encoding="utf-8")
    if layout == "two_sets":
        part = root / "SPEECHIO_ASR_ZH00003"
        _wav(part / "wavs" / "b_0001.wav", seed=16)
        _wav(part / "wavs" / "c_0002.wav", seed=17)
        (part / "metadata.tsv").write_text(
            "ID\tAUDIO\tTEXT\nb_0001\twavs/b_0001.wav\t第一\nx_0009\twavs/x_0009.wav\t缺失\n"
            "c_0002\twavs/c_0002.wav\t第二\n", encoding="utf-8")
    return root


def kespeech_tree(root, layout="tranche3", n=2, seed=0):
    """``tranche3``: tests/test_recipes_tranche3.py:102 (one utterance of the
    test part); ``parts``: utterances in ``train_phase1``, ``dev_phase1``
    and ``test`` over several subdialects; ``slice``: ``n`` tone bursts of
    1.2-2 s in ``train_phase1``; ``misaligned``: ``utt2spk`` a line out of
    step."""
    if layout == "tranche3":
        _wav(root / "Audio" / "u1.wav", seed=11)
        parts = {"test": [("u1", "Audio/u1.wav", "<SPOKEN_NOISE>你好", "Mandarin", "spk1")]}
    elif layout in ("parts", "misaligned"):
        parts, k = {}, 0
        for part, count in (("train_phase1", 4), ("dev_phase1", 2), ("test", 2)):
            for i in range(count):
                utt = f"10{k:04d}_{1 + k % 3}"
                _wav(root / "Audio" / f"{utt}.wav", seconds=0.5 + 0.1 * k, seed=20 + k)
                parts.setdefault(part, []).append(
                    (utt, f"Audio/{utt}.wav", f"<SPOKEN_NOISE>第{k}句", ("Mandarin", "Beijing",
                                                                         "Southwestern")[k % 3],
                     f"spk{k % 3}"))
                k += 1
    else:
        rng = np.random.RandomState(seed)
        parts = {"train_phase1": []}
        for i in range(n):
            utt = f"1000{i}_{700 + i}"
            _burst(root / "Audio" / f"{utt}.wav", rng, rng.uniform(1.2, 2.0), f0=520 + 25 * i)
            parts["train_phase1"].append(
                (utt, f"Audio/{utt}.wav", f"{_text(rng)}<SPOKEN_NOISE>", "Jiang-Huai",
                 f"{700 + i}"))
    for part, rows in parts.items():
        task = root / "Tasks" / "ASR" / part
        task.mkdir(parents=True, exist_ok=True)
        spk = [f"{r[0]} {r[4]}" for r in rows]
        if layout == "misaligned":
            spk = spk[1:] + spk[:1]
        for name, lines in (("wav.scp", [f"{r[0]} {r[1]}" for r in rows]),
                            ("text", [f"{r[0]} {r[2]}" for r in rows]),
                            ("utt2subdialect", [f"{r[0]} {r[3]}" for r in rows]),
                            ("utt2spk", spk)):
            (task / name).write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root


def aishell3_tree(root, layout="tranche2"):
    """``tranche2``: tests/test_recipes_tranche2.py:296, 44.1 kHz; ``wide``:
    a second speaker without a gender line, an utterance without tone
    labels, and a content line whose file is missing (skipped)."""
    (root / "train").mkdir(parents=True, exist_ok=True)
    speakers = "# header\nSSB0005\tA\tfemale\tnorth\n"
    tones = "#\nSSB00050001|ni2 hao3|你好\n"
    content = {"train": ["SSB00050001.wav\t你 ni2 好 hao3"],
               "test": ["SSB00050002.wav\t世 shi4 界 jie4"]}
    _wav(root / "train" / "wav" / "SSB0005" / "SSB00050001.wav", sr=44100, seed=63)
    _wav(root / "test" / "wav" / "SSB0005" / "SSB00050002.wav", sr=44100, seed=64)
    if layout == "wide":
        speakers += "SSB0009\tB\tmale\tsouth\n"
        _wav(root / "train" / "wav" / "SSB0009" / "SSB00090003.wav", sr=44100, seed=65)
        _wav(root / "train" / "wav" / "SSB0011" / "SSB00110004.wav", sr=44100, seed=66)
        content["train"] += ["SSB00090003.wav\t早 zao3 上 shang4", "SSB00110004.wav\t好 hao3",
                             "SSB00090099.wav\t缺 que1"]
    (root / "spk-info.txt").write_text(speakers)
    (root / "train" / "label_train-set.txt").write_text(tones)
    for part, lines in content.items():
        (root / part / "content.txt").write_text("\n".join(lines) + "\n")
    return root


def baker_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:14 (16 kHz);
    ``published``: 48 kHz, and a labelled utterance without its file."""
    sr = 16000 if layout == "tranche3" else 48000
    _wav(root / "Wave" / "000001.wav", sr=sr, seed=1)
    _wav(root / "Wave" / "000002.wav", sr=sr, seed=2)
    lines = ("000001\t卡尔普#2陪外孙#1玩滑梯#4。\n"
             "\tka2 er2 pu3 pei2 wai4 sun1 wan2 hua2 ti1\n"
             "000002\t假语村言#2别再#1拥抱我#4。\n"
             "\tjia2 yu3 cun1 yan2 bie2 zai4 yong1 bao4 wo3\n")
    if layout == "published":
        lines += "000003\t缺失#3的#5文件#4。\n\tque1 shi1 de5 wen2 jian4\n"
    (root / "ProsodyLabeling").mkdir(parents=True, exist_ok=True)
    (root / "ProsodyLabeling" / "000001-010000.txt").write_text(lines, encoding="utf-8")
    return root


def wenetspeech4tts_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:121 (one Premium file);
    ``tiers``: a file of each tier, a listed file without its ``txts``
    sibling and one without audio; ``no_dotdot``: a listed path that does
    not start with ``../``."""
    files = [("X001_S1", "Premium/WenetSpeech4TTS_Premium_1", "你好世界")]
    if layout == "tiers":
        files += [("Y002_S2", "Standard/WenetSpeech4TTS_Standard_2", "标准音质"),
                  ("Z003_S3", "Basic/WenetSpeech4TTS_Basic_3", "基础音质"),
                  ("Z004_S4", "Basic/WenetSpeech4TTS_Basic_3", None),
                  ("Z005_S5", "Basic/WenetSpeech4TTS_Basic_4", "无音频")]
    listed = []
    for i, (name, pack, text) in enumerate(files):
        if name != "Z005_S5":
            _wav(root / pack / "wavs" / f"{name}.wav", seed=12 + i)
        if text is not None:
            (root / pack / "txts").mkdir(parents=True, exist_ok=True)
            (root / pack / "txts" / f"{name}.txt").write_text(
                f"{name}\t{text}\n[0.0,{1.0 + i}]\n", encoding="utf-8")
        prefix = "" if layout == "no_dotdot" else "../"
        listed.append(f"{name} {prefix}{pack}/wavs/{name}.wav")
    (root / "filelists").mkdir(parents=True, exist_ok=True)
    (root / "filelists" / "Basic_filelist.lst").write_text("\n".join(listed) + "\n")
    (root / "DNSMOS_P808Scores").mkdir(exist_ok=True)
    for k, tier in enumerate(("Basic", "Premium", "Standard")):
        scores = [f"{name} {4.01 - 0.1 * (i + k)}" for i, (name, _, _) in enumerate(files)
                  if name != "Z003_S3"]  # one file without a score
        (root / "DNSMOS_P808Scores" / f"{tier}_DNSMOS.lst").write_text("\n".join(scores) + "\n")
    return root


def xbmu_tree(root, layout="tranche3"):
    """``tranche3``: tests/test_recipes_tranche3.py:141 (train only);
    ``full``: every split, two speakers, a file without a transcript."""
    _wav(root / "data" / "wav" / "train" / "spk1" / "spk1-u001.wav", seed=13)
    lines = "u001 tibetan words here\n"
    if layout == "full":
        _wav(root / "data" / "wav" / "train" / "spk2" / "spk2-u002.wav", seed=18)
        _wav(root / "data" / "wav" / "train" / "spk2" / "spk2-u099.wav", seed=19)
        _wav(root / "data" / "wav" / "dev" / "spk3" / "spk3-u003.wav", seed=20)
        _wav(root / "data" / "wav" / "test" / "spk4" / "spk4-u004.wav", seed=21)
        lines += "u002 ཀ ཁ ག\nu003 ང ཅ\nu004 ཆ ཇ ཉ\n"
    tr = root / "data" / "transcript"
    tr.mkdir(parents=True, exist_ok=True)
    (tr / "transcript_clean.txt").write_text(lines, encoding="utf-8")
    return root


def mdcc_tree(root, layout="tranche2"):
    """``tranche2``: tests/test_recipes_tranche2.py:464 (train only, the
    other splits' metadata empty); ``full``: a row in every split."""
    rows = {"train": [1], "valid": [], "test": []}
    if layout == "full":
        rows = {"train": [1, 2], "valid": [3], "test": [4]}
    (root / "transcription").mkdir(parents=True)
    for part, ids in rows.items():
        for i in ids:
            _wav(root / "audio" / f"{i}.wav", seed=88 + i)
            (root / "transcription" / f"{i}.txt").write_text("早晨" if i == 1 else f"第{i}句")
        (root / f"cnt_asr_{part}_metadata.csv").write_text(
            "audio_path,text_path,gender,duration\n" + "".join(
                f"./audio/{i}.wav,./transcription/{i}.txt,{'FM'[i % 2]},1.0\n" for i in ids))
    return root


# -- every recipe against JAX ---------------------------------------------------------------

P = {"thchs_30": pthchs.prepare_thchs_30, "stcmds": pstcmds.prepare_stcmds,
     "primewords": pprimewords.prepare_primewords, "magicdata": pmagicdata.prepare_magicdata,
     "aidatatang_200zh": paidatatang.prepare_aidatatang_200zh,
     "tal_asr": ptal_asr.prepare_tal_asr, "tal_csasr": ptal_csasr.prepare_tal_csasr,
     "cdsd": pcdsd.prepare_cdsd, "kespeech": pkespeech.prepare_kespeech,
     "aishell3": paishell3.prepare_aishell3, "baker_zh": pbaker.prepare_baker_zh,
     "wenetspeech4tts": pwenet4tts.prepare_wenetspeech4tts,
     "speechio": pspeechio.prepare_speechio, "xbmu_amdo31": pxbmu.prepare_xbmu_amdo31,
     "mdcc": pmdcc.prepare_mdcc}
JP = {"thchs_30": jthchs.prepare_thchs_30, "stcmds": jstcmds.prepare_stcmds,
      "primewords": jprimewords.prepare_primewords, "magicdata": jmagicdata.prepare_magicdata,
      "aidatatang_200zh": jaidatatang.prepare_aidatatang_200zh,
      "tal_asr": jtal_asr.prepare_tal_asr, "tal_csasr": jtal_csasr.prepare_tal_csasr,
      "cdsd": jcdsd.prepare_cdsd, "kespeech": jkespeech.prepare_kespeech,
      "aishell3": jaishell3.prepare_aishell3, "baker_zh": jbaker.prepare_baker_zh,
      "wenetspeech4tts": jwenet4tts.prepare_wenetspeech4tts,
      "speechio": jspeechio.prepare_speechio, "xbmu_amdo31": jxbmu.prepare_xbmu_amdo31,
      "mdcc": jmdcc.prepare_mdcc}

# (recipe, the function that writes its layout, keyword arguments of both prepare_* calls)
CASES = {
    "thchs_30-recipes": ("thchs_30", lambda r: thchs_tree(r, "recipes"), {}),
    "thchs_30-tranche4": ("thchs_30", lambda r: thchs_tree(r, "tranche4"), {}),
    "thchs_30-slice": ("thchs_30", lambda r: thchs_tree(r, "slice", n=6), {}),
    "stcmds-recipes": ("stcmds", lambda r: stcmds_tree(r, "recipes"), {}),
    "stcmds-tranche4": ("stcmds", lambda r: stcmds_tree(r, "tranche4"), {}),
    "stcmds-wide": ("stcmds", lambda r: stcmds_tree(r, "wide"), {}),
    "primewords-recipes": ("primewords", lambda r: primewords_tree(r, "recipes"), {}),
    "primewords-tranche4": ("primewords", lambda r: primewords_tree(r, "tranche4"), {}),
    "magicdata-recipes": ("magicdata", lambda r: magicdata_tree(r, "recipes"), {}),
    "magicdata-tranche4": ("magicdata", lambda r: magicdata_tree(r, "tranche4"), {}),
    "magicdata-slice": ("magicdata", lambda r: magicdata_tree(r, "slice", n=6), {}),
    "aidatatang_200zh-recipes": ("aidatatang_200zh", lambda r: aidatatang_tree(r, "recipes"), {}),
    "aidatatang_200zh-tranche4": ("aidatatang_200zh", lambda r: aidatatang_tree(r, "tranche4"),
                                  {}),
    "tal_asr-tranche3": ("tal_asr", lambda r: tal_asr_tree(r, "tranche3"), {}),
    "tal_asr-full": ("tal_asr", lambda r: tal_asr_tree(r, "full"), {}),
    "tal_csasr": ("tal_csasr", tal_csasr_tree, {}),
    "cdsd": ("cdsd", cdsd_tree, {}),
    "kespeech-tranche3": ("kespeech", lambda r: kespeech_tree(r, "tranche3"),
                          {"dataset_parts": ["test"]}),
    "kespeech-parts-all": ("kespeech", lambda r: kespeech_tree(r, "parts"),
                           {"dataset_parts": ["train_phase1", "dev_phase1", "test"]}),
    "kespeech-parts-one": ("kespeech", lambda r: kespeech_tree(r, "parts"),
                           {"dataset_parts": "dev_phase1", "num_jobs": 2}),
    "aishell3-tranche2": ("aishell3", lambda r: aishell3_tree(r, "tranche2"), {}),
    "aishell3-wide": ("aishell3", lambda r: aishell3_tree(r, "wide"), {}),
    "baker_zh-tranche3": ("baker_zh", lambda r: baker_tree(r, "tranche3"), {}),
    "baker_zh-published": ("baker_zh", lambda r: baker_tree(r, "published"), {}),
    "wenetspeech4tts-tranche3-all": ("wenetspeech4tts", lambda r: wenetspeech4tts_tree(r),
                                     {"dataset_parts": "all"}),
    "wenetspeech4tts-tiers-all": ("wenetspeech4tts", lambda r: wenetspeech4tts_tree(r, "tiers"),
                                  {"dataset_parts": ["all"]}),
    "wenetspeech4tts-tiers-standard": ("wenetspeech4tts",
                                       lambda r: wenetspeech4tts_tree(r, "tiers"),
                                       {"dataset_parts": "Standard"}),
    "speechio-tranche3": ("speechio", lambda r: speechio_tree(r, "tranche3"), {}),
    "speechio-two_sets": ("speechio", lambda r: speechio_tree(r, "two_sets"), {}),
    "xbmu_amdo31-tranche3": ("xbmu_amdo31", lambda r: xbmu_tree(r, "tranche3"), {}),
    "xbmu_amdo31-full": ("xbmu_amdo31", lambda r: xbmu_tree(r, "full"), {}),
    "mdcc-tranche2": ("mdcc", lambda r: mdcc_tree(r, "tranche2"), {}),
    "mdcc-full": ("mdcc", lambda r: mdcc_tree(r, "full"), {}),
    "mdcc-valid": ("mdcc", lambda r: mdcc_tree(r, "full"), {"dataset_parts": "valid"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_equals_jax(tmp_path, case):
    """The returned manifests and the written files of each package's
    ``prepare_*`` on the same layout are equal."""
    recipe, build, kwargs = CASES[case]
    corpus = build(tmp_path / "corpus")
    _, written = _both(tmp_path, P[recipe], JP[recipe], corpus, **kwargs)
    assert any(len(m) for m in written.values())


def _sups(made, part=None):
    return list((made[part] if part else made)["supervisions"])


def test_prepared_fields_as_the_jax_tests_expect(tmp_path):
    """The JAX tests' assertions, on the port's manifests."""
    (sup,) = _sups(P["stcmds"](stcmds_tree(tmp_path / "st")), "train")
    assert sup.text == "你好世界" and sup.speaker == "P00001A"
    (sup,) = _sups(P["thchs_30"](thchs_tree(tmp_path / "th")), "train")
    assert sup.text == "绿 是 阳春" and sup.speaker == "A11"
    (sup,) = _sups(P["magicdata"](magicdata_tree(tmp_path / "mg")), "train")
    assert sup.text == "你好世界" and sup.speaker == "SPK01"
    (sup,) = _sups(P["primewords"](primewords_tree(tmp_path / "pw")), "train")
    assert sup.text == "早上好" and sup.speaker == "42"
    made = P["aidatatang_200zh"](aidatatang_tree(tmp_path / "adt"))
    (sup,) = _sups(made, "train")
    assert sup.text == "ＴＥA 早上 好" and sup.speaker == "G0001" and set(made) == {
        "train", "dev", "test"}
    dev = _sups(P["tal_asr"](tal_asr_tree(tmp_path / "tal")), "dev")
    assert dev[0].text.startswith("APPLE")
    (sup,) = _sups(P["tal_csasr"](tal_csasr_tree(tmp_path / "tcs")), "train_set")
    assert "HI WORLD" in sup.text and "！" not in sup.text and sup.speaker == "u5"
    (sup,) = _sups(P["cdsd"](cdsd_tree(tmp_path / "cdsd")), "1h")
    assert sup.speaker == "S01" and " " not in sup.text and "TEST" in sup.text
    (sup,) = _sups(P["kespeech"](kespeech_tree(tmp_path / "ke"), dataset_parts=["test"]), "test")
    assert sup.text == "你好" and sup.language == "Mandarin" and sup.speaker == "spk1"
    (sup,) = _sups(P["aishell3"](aishell3_tree(tmp_path / "a3")), "train")
    assert sup.text == "你好" and sup.custom["pinyin"] == "ni2 hao3" and sup.gender == "female"
    sups = sorted(_sups(P["baker_zh"](baker_tree(tmp_path / "bk"))), key=lambda s: s.id)
    assert "#2" in sups[0].text and "#" not in sups[0].custom["normalized_text"]
    made = P["wenetspeech4tts"](wenetspeech4tts_tree(tmp_path / "w4"), dataset_parts="all")
    assert all(_sups(made, t)[0].custom["dns_mos"] == pytest.approx(4.01 - 0.1 * k)
               for k, t in enumerate(("Basic", "Premium", "Standard")))
    (sup,) = _sups(P["speechio"](speechio_tree(tmp_path / "sio")), "SPEECHIO_ASR_ZH00000")
    assert sup.text == "测试文本" and sup.speaker == "a"
    (sup,) = _sups(P["xbmu_amdo31"](xbmu_tree(tmp_path / "xb")), "train")
    assert sup.recording_id == "spk1-u001" and sup.language == "tibetan"
    made = P["mdcc"](mdcc_tree(tmp_path / "mdcc"))
    assert set(made) == {"train"} and _sups(made, "train")[0].language == "yue"


@pytest.mark.parametrize("recipe", ["aishell3", "kespeech", "speechio", "wenetspeech4tts"])
def test_a_second_run_reads_the_cached_manifests_as_jax(tmp_path, recipe):
    """The recipes that look for manifests an earlier run wrote return
    them, as JAX's do, even after the corpus's audio is gone."""
    build, kwargs = {
        "aishell3": (lambda r: aishell3_tree(r, "wide"), {}),
        "kespeech": (lambda r: kespeech_tree(r, "parts"), {"dataset_parts": ["test"]}),
        "speechio": (lambda r: speechio_tree(r, "two_sets"), {}),
        "wenetspeech4tts": (lambda r: wenetspeech4tts_tree(r, "tiers"),
                            {"dataset_parts": "Premium"}),
    }[recipe]
    corpus = build(tmp_path / "corpus")
    first, _ = _both(tmp_path, P[recipe], JP[recipe], corpus, **kwargs)
    # The audio goes; the text files each recipe reads before it looks at the cache stay.
    for wav in list(corpus.rglob("*.wav")):
        wav.unlink()
    again = P[recipe](corpus, output_dir=tmp_path / "ours", **kwargs)
    assert _dicts(again) == _dicts(JP[recipe](corpus, output_dir=tmp_path / "jax", **kwargs))
    assert _dicts(again) == _dicts(first)


def test_kespeech_is_the_same_at_any_num_jobs(tmp_path):
    corpus = kespeech_tree(tmp_path / "corpus", "parts")
    parts = ["train_phase1", "dev_phase1", "test"]
    one = P["kespeech"](corpus, dataset_parts=parts, num_jobs=1)
    four = P["kespeech"](corpus, dataset_parts=parts, num_jobs=4)
    assert _dicts(one) == _dicts(four) == _dicts(JP["kespeech"](corpus, dataset_parts=parts,
                                                                 num_jobs=4))
    assert [len(one[p]["recordings"]) for p in parts] == [4, 2, 2]


@pytest.mark.parametrize("case", ["kespeech-misaligned", "kespeech-unknown-part",
                                  "kespeech-all-with-absent-parts", "wenetspeech4tts-no-dotdot",
                                  "wenetspeech4tts-unknown-tier", "mdcc-unknown-part",
                                  "baker_zh-no-labels", "primewords-no-table"])
def test_refuses_as_jax(tmp_path, case):
    """Each package raises the same error with the same message."""
    recipe = case.split("-")[0]
    corpus, kwargs = tmp_path / "corpus", {}
    if case == "kespeech-misaligned":
        kespeech_tree(corpus, "misaligned")
        kwargs = {"dataset_parts": ["train_phase1"], "num_jobs": 2}
    elif case == "kespeech-unknown-part":
        kespeech_tree(corpus)
        kwargs = {"dataset_parts": ["bogus"]}
    elif case == "kespeech-all-with-absent-parts":
        kespeech_tree(corpus)  # only "test" exists: the other parts' files are missing
    elif recipe == "wenetspeech4tts":
        wenetspeech4tts_tree(corpus, "no_dotdot" if case.endswith("dotdot") else "tranche3")
        kwargs = {"dataset_parts": "all" if case.endswith("dotdot") else "Gold"}
    elif recipe == "mdcc":
        mdcc_tree(corpus)
        kwargs = {"dataset_parts": "dev"}
    else:
        corpus.mkdir()
    errors = []
    for prepare in (P[recipe], JP[recipe]):
        with pytest.raises(Exception) as info:
            prepare(corpus, **kwargs)
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]
    if case == "kespeech-misaligned":
        assert errors[0][0] == "AssertionError" and "Misaligned" in errors[0][1]
    if case == "wenetspeech4tts-no-dotdot":
        assert errors[0][0] == "AssertionError" and "no '../'" in errors[0][1]


@pytest.mark.parametrize("recipe", sorted(P))
def test_prepare_refuses_a_missing_corpus_as_jax(tmp_path, recipe):
    errors = []
    for prepare in (P[recipe], JP[recipe]):
        with pytest.raises(AssertionError) as info:
            prepare(tmp_path / "no-such-dir")
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_build_part_manifests_keeps_an_empty_split_empty(tmp_path):
    """``_zh_common``'s guard: an absent split yields empty manifests (where
    ``fix_manifests`` would assert), and the stored files are empty too."""
    from lhotse_tpu.recipes import _zh_common as jzh_common

    made = pzh_common.build_part_manifests([], {}, speaker_of=lambda p: None)
    assert len(made["recordings"]) == len(made["supervisions"]) == 0
    pzh_common.maybe_store(made, tmp_path / "ours", "x", "dev")
    jzh_common.maybe_store(jzh_common.build_part_manifests([], {}, speaker_of=lambda p: None),
                           tmp_path / "jax", "x", "dev")
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == ["x_recordings_dev.jsonl.gz", "x_supervisions_dev.jsonl.gz"]
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    pzh_common.maybe_store(made, None, "x", "dev")  # no output directory: nothing written


# -- the text normalizers ---------------------------------------------------------------------

NORMALIZED = [
    ("thchs_30", "绿 是 阳春 烟 景"), ("thchs_30", "ka2 l = er2 ａb"),
    ("stcmds", "你好，世界"), ("stcmds", "ｎｉ，hao"),
    ("magicdata", "你好！世界[FIL]"), ("magicdata", "你好，世界！"),
    ("magicdata", "[SPK]《好》 ok? a/b “c”…、　x"),
    ("tal_asr", "你好，世界。"), ("tal_asr", "Ａpple#测试"), ("tal_asr", "上课=了|、同学们？"),
    ("tal_csasr", "上面是 ＨＩ world！"), ("tal_csasr", "ＡＣＤ ａ \"q\" a.b~c《d》@e-f:g"),
    ("cdsd", "你 好 ｔest"), ("cdsd", "ａｂｃｋｔ xyz"),
    ("kespeech", "<SPOKEN_NOISE>你好"), ("kespeech", "你<SPOKEN_NOISE>好 <SPOKEN_NOISE>"),
]
MODULES = {"thchs_30": (pthchs, jthchs), "stcmds": (pstcmds, jstcmds),
           "magicdata": (pmagicdata, jmagicdata), "tal_asr": (ptal_asr, jtal_asr),
           "tal_csasr": (ptal_csasr, jtal_csasr), "cdsd": (pcdsd, jcdsd),
           "kespeech": (pkespeech, jkespeech)}


@pytest.mark.parametrize("recipe,text", NORMALIZED)
def test_text_normalizers_equal_jax(recipe, text):
    ours, theirs = MODULES[recipe]
    assert ours.text_normalize(text) == theirs.text_normalize(text)


def test_normalized_strings_of_the_jax_tests():
    assert pstcmds.text_normalize("你好，世界") == "你好世界"
    assert pmagicdata.text_normalize("你好！世界[FIL]") == "你好世界"
    assert ptal_asr.text_normalize("Ａpple#测试").startswith("APPLE")
    assert "HI WORLD" in ptal_csasr.text_normalize("上面是 ＨＩ world！")
    assert pkespeech.text_normalize("<SPOKEN_NOISE>你好") == "你好"
    assert pbaker._PROSODY_MARKS.sub("", "卡尔普#2陪外孙#1玩滑梯#4。") == "卡尔普陪外孙玩滑梯。"
    assert pbaker._PROSODY_MARKS.pattern == jbaker._PROSODY_MARKS.pattern


def test_read_tal_transcripts_equals_jax(tmp_path):
    path = tmp_path / "label.txt"
    path.write_text("u1 你好，世界。\n\nu2  ＨＩ   world！ \nu3\n", encoding="utf-8")
    for normalize in (ptal_asr.text_normalize, ptal_csasr.text_normalize):
        assert ptal_asr.read_tal_transcripts(path, normalize) == jtal_asr.read_tal_transcripts(
            path, normalize)


# -- the prepare commands ---------------------------------------------------------------------

# (command arguments, the layout, the port's function call)
COMMANDS = {
    "thchs-30": (["thchs-30"], lambda r: thchs_tree(r, "slice", n=6),
                 lambda c, o: P["thchs_30"](c, output_dir=o)),
    "stcmds": (["stcmds"], lambda r: stcmds_tree(r, "wide"),
               lambda c, o: P["stcmds"](c, output_dir=o)),
    "primewords": (["primewords"], lambda r: primewords_tree(r, "tranche4"),
                   lambda c, o: P["primewords"](c, output_dir=o)),
    "magicdata": (["magicdata"], lambda r: magicdata_tree(r, "slice", n=6),
                  lambda c, o: P["magicdata"](c, output_dir=o)),
    "aidatatang-200zh": (["aidatatang-200zh"], lambda r: aidatatang_tree(r, "recipes"),
                         lambda c, o: P["aidatatang_200zh"](c, output_dir=o)),
    "tal-asr": (["tal-asr"], lambda r: tal_asr_tree(r, "full"),
                lambda c, o: P["tal_asr"](c, output_dir=o)),
    "tal-csasr": (["tal-csasr", "-j", "2"], tal_csasr_tree,
                  lambda c, o: P["tal_csasr"](c, output_dir=o)),
    "cdsd": (["cdsd"], cdsd_tree, lambda c, o: P["cdsd"](c, output_dir=o)),
    "kespeech": (["kespeech", "-p", "train_phase1", "-p", "dev_phase1", "-p", "test", "-j", "3"],
                 lambda r: kespeech_tree(r, "parts"),
                 lambda c, o: P["kespeech"](c, output_dir=o,
                                            dataset_parts=["train_phase1", "dev_phase1", "test"])),
    "aishell3": (["aishell3"], lambda r: aishell3_tree(r, "wide"),
                 lambda c, o: P["aishell3"](c, output_dir=o)),
    "baker-zh": (["baker-zh"], lambda r: baker_tree(r, "published"),
                 lambda c, o: P["baker_zh"](c, output_dir=o)),
    "wenetspeech4tts": (["wenetspeech4tts", "-p", "all"],
                        lambda r: wenetspeech4tts_tree(r, "tiers"),
                        lambda c, o: P["wenetspeech4tts"](c, output_dir=o, dataset_parts="all")),
    "wenetspeech4tts-default": (["wenetspeech4tts"], lambda r: wenetspeech4tts_tree(r, "tiers"),
                                lambda c, o: P["wenetspeech4tts"](c, output_dir=o)),
    "speechio": (["speechio"], lambda r: speechio_tree(r, "two_sets"),
                 lambda c, o: P["speechio"](c, output_dir=o)),
    "xbmu-amdo31": (["xbmu-amdo31"], lambda r: xbmu_tree(r, "full"),
                    lambda c, o: P["xbmu_amdo31"](c, output_dir=o)),
    "MDCC": (["MDCC"], lambda r: mdcc_tree(r, "full"), lambda c, o: P["mdcc"](c, output_dir=o)),
    "mdcc-train-test": (["mdcc", "-p", "train", "-p", "test"], lambda r: mdcc_tree(r, "full"),
                        lambda c, o: P["mdcc"](c, output_dir=o, dataset_parts=["train", "test"])),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_prepare_command_writes_what_its_function_writes(tmp_path, name):
    """Each ``prepare`` command writes the manifests its function writes, and
    the JAX CLI's command the same, compared as dicts with the output
    directory replaced."""
    from test_torch_cli import _both as both_clis
    from test_torch_cli import _normalized

    args, build, function = COMMANDS[name]
    corpus = build(tmp_path / "corpus")
    runs = both_clis(tmp_path, "prepare", *args, corpus, "{out}", seed=0)
    function(corpus, tmp_path / "function")
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    names = sorted(p.name for p in pout.glob("*.jsonl.gz"))
    assert names and names == sorted(p.name for p in (tmp_path / "function").glob("*.jsonl.gz"))
    assert names == sorted(p.name for p in jout.glob("*.jsonl.gz"))
    total = 0
    for name_ in names:
        ours = _normalized(pout / name_, pout)
        assert _normalized(tmp_path / "function" / name_, tmp_path / "function") == ours
        assert _normalized(jout / name_, jout) == ours
        total += len(ours)
    assert total


# -- the slice: three muxed corpora into the on-device chain and on-the-fly features ---------

MUX_SEED = 22


def _muxed_cuts(pkg, roots):
    """Each package's THCHS-30, MagicData and KeSpeech layouts →
    ``prepare_*`` → ``CutSet.from_manifests`` of every split →
    ``CutSet.mux(weights=[1, 1, 1])``, as a list."""
    if pkg == "port":
        CS, seed_fn, recipes = CutSet, fix_random_seed, P
    else:
        CS, seed_fn, recipes = J.CutSet, jfix, JP
    made = [recipes["thchs_30"](roots["thchs_30"]), recipes["magicdata"](roots["magicdata"]),
            recipes["kespeech"](roots["kespeech"], dataset_parts=["train_phase1"])]
    seed_fn(0)
    sets = [CS.from_cuts(c for part in m.values() for c in CS.from_manifests(**part))
            for m in made]
    return list(CS.mux(*sets, weights=[1, 1, 1], seed=MUX_SEED))


def _bucketed(cuts, bucket=(2.0, 4)):
    audio = [c.load_audio()[0] for c in cuts]
    out = []
    for i in range(0, len(audio), bucket[1]):
        rows = audio[i:i + bucket[1]]
        lens = np.array([len(x) for x in rows])
        batch = np.zeros((len(rows), lens.max()), np.float32)
        for k, x in enumerate(rows):
            batch[k, :len(x)] = x
        out.append((batch, lens))
    return out


@pytest.fixture(scope="module")
def zh_slice(tmp_path_factory):
    root = tmp_path_factory.mktemp("zh_slice")
    roots = {"thchs_30": thchs_tree(root / "thchs", "slice", n=3, seed=1),
             "magicdata": magicdata_tree(root / "magicdata", "slice", n=3, seed=2),
             "kespeech": kespeech_tree(root / "kespeech", "slice", n=2, seed=3)}
    ours, theirs = _muxed_cuts("port", roots), _muxed_cuts("jax", roots)
    return root, ours, theirs


class _JaxKernelRoute64(_JaxKernelRoute):
    """The JAX fbank layer's kernel route with its DFT and mel products and
    its log in float64 (numpy, through ``jax.pure_callback``), on the JAX
    chain's framed float32 audio and the layer's float32 matrices. The
    port's CPU route takes its DFT products in float64 as well."""

    def __call__(self, x):
        import jax
        import jax.numpy as jnp
        from lhotse_tpu.ops import fbank as jops

        frames = jops.frame_signal(x, 400, 160, snip_edges=False)
        Mc, Ms, fb = (np.asarray(m, np.float64) for m in (self.Mc, self.Ms, self.fb))

        def route(f):
            f = np.asarray(f, np.float64)
            power = (f @ Mc) ** 2 + (f @ Ms) ** 2
            return np.log(np.maximum(power @ fb, jops.FLT_EPS)).astype(np.float32)

        return jax.pure_callback(
            route, jax.ShapeDtypeStruct(frames.shape[:-1] + (fb.shape[1],), jnp.float32), frames)


def test_zh_mux_fed_augmenter_equals_jax(zh_slice):
    """The port's augmenter within ``AUG_TOL`` of the JAX augmenter whose
    fbank stage is its kernel route in float64 (9.06e-5 apart on this mux,
    the rest of both chains in float32). Against the JAX kernel
    route in XLA's float32 this mux parts by up to 1.37e-4, in a low mel
    bin at -15.36 of a padded frame: there the two float32 routes err in
    opposite directions, the port's by 6.7e-5 and JAX's by 7.0e-5 from the
    same stages in float64 (``_Float64Torch`` and ``_Float64Fbank`` of
    tests/test_torch_host_loader.py)."""
    root, ours, theirs = zh_slice
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs] and len(ours) == 8
    # THCHS-30 ids start with a letter, KeSpeech's with 1000, MagicData's with 3.
    corpora = ["thchs_30" if c.recording_id[0].isalpha() else
               "kespeech" if c.recording_id.startswith("1000") else "magicdata" for c in ours]
    assert sorted(corpora) == ["kespeech"] * 2 + ["magicdata"] * 3 + ["thchs_30"] * 3
    assert len(set(corpora[:4])) > 1 and len(set(corpora[4:])) > 1  # each batch mixes corpora
    musan, rirs = musan_tree(root / "musan", "pool"), rir_noise_tree(root / "RIRS", 2)
    pool = noise_pool(pmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"])
    rir = seeded_rir(prir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"])
    assert np.array_equal(
        pool, noise_pool(jmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"]))
    assert np.array_equal(
        rir, seeded_rir(jrir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"]))
    common = dict(speed_factor=1.1, noise_pool=pool, rir=rir, snr=(10, 20), mix_prob=0.5, seed=5)
    port = OnDeviceAugmenter([(2.0, 4)], wire_format="int16", specaugment=SpecAugment(seed=7),
                             device="cpu", **common)
    jax_aug = JAugmenter([(2.0, 4)], wire_format="int16", specaugment=JSpecAugment(seed=7),
                         fbank=_JaxKernelRoute64(), **common)
    batches = _bucketed(ours)
    for (audio, lens), (jaudio, jlens) in zip(batches, _bucketed(theirs)):
        assert np.array_equal(audio, jaudio) and np.array_equal(lens, jlens)
    assert [len(lens) for _, lens in batches] == [4, 4]
    mixed = 0
    for audio, lens in batches:
        s_ours, s_theirs = port.stage(audio, lens), jax_aug.stage(audio, lens)
        mixed += int(np.asarray(s_ours.kwargs["mix_mask"]).sum())
        feats, feat_lens = port.compute(s_ours)
        jfeats, jfeat_lens = jax_aug.compute(s_theirs)
        assert tuple(feats.shape) == np.asarray(jfeats).shape == (4, 182, 80)
        assert np.isfinite(feats.numpy()).all()
        assert np.array_equal(feat_lens.numpy(), np.asarray(jfeat_lens))
        np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=AUG_TOL)
    assert mixed > 0  # the MUSAN pool went into some rows


def test_zh_mux_on_the_fly_equals_jax(zh_slice):
    _, ours, theirs = zh_slice
    dataset = K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    # The JAX extractors' device route, in XLA on the CPU.
    jdataset = JDataset(return_cuts=True,
                        input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))))
    texts = []
    for i in range(0, len(ours), 4):
        a = dataset[CutSet.from_cuts(ours[i:i + 4])]
        b = jdataset[J.CutSet.from_cuts(theirs[i:i + 4])]
        assert a["inputs"].shape == b["inputs"].shape and np.isfinite(a["inputs"]).all()
        np.testing.assert_allclose(a["inputs"], b["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        for key in ("sequence_idx", "start_frame", "num_frames"):
            np.testing.assert_array_equal(a["supervisions"][key], b["supervisions"][key])
        assert a["supervisions"]["text"] == b["supervisions"]["text"]
        texts += a["supervisions"]["text"]
    assert len(texts) == 8
    # The normalizers ran: no THCHS-30 marker, no MagicData noise token, no KeSpeech noise.
    assert not any(m in t for t in texts for m in (" l =", "[SPK]", "SPK", "<SPOKEN_NOISE>", "，"))
