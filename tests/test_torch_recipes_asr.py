"""
The port's single-stream ASR and speaker recipes (lhotse_tpu_torch.recipes
``yesno``, ``aishell``, ``aishell2``, ``tedlium``, ``tedlium2``,
``librilight``, ``mls``, ``peoples_speech``, ``spgispeech``, ``timit`` and
``voxceleb``) against the JAX package's, on the fixture layouts of
tests/test_recipes.py and tests/test_recipes_tranche{2,5,6,7,10}.py (made
from a numpy seed), their text normalizers on the JAX tests' strings, and
the slice as a whole at a small size:

- an AISHELL layout of 8 utterances through each package's
  ``prepare_aishell``, its audio at a 2 s x 4 bucket with an int16 wire
  into each package's ``OnDeviceAugmenter`` with the same MUSAN noise pool,
  real RIR and seed (speed 1.1, SNR (10, 20), SpecAugment): within 1e-4,
  the bound of tests/test_torch_device_augment.py, of the JAX augmenter
  with the JAX fbank layer's kernel route;
- a TED-LIUM 3 layout of SPHERE talks through each package's
  ``prepare_tedlium`` → ``CutSet.from_manifests`` → ``trim_to_supervisions``
  → ``K2SpeechRecognitionDataset`` with ``OnTheFlyFeatures``: the same cuts,
  and features within ``EXTRACTOR_TOL`` of the JAX chain with its
  extractor's device route.

Written ``.jsonl.gz`` manifests are compared after decompression, since a
gzip header carries its write time.
"""
import json

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
from lhotse_tpu.recipes import aishell as jaishell
from lhotse_tpu.recipes import aishell2 as jaishell2
from lhotse_tpu.recipes import librilight as jlibrilight
from lhotse_tpu.recipes import mls as jmls
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import peoples_speech as jpeoples
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.recipes import spgispeech as jspgi
from lhotse_tpu.recipes import tedlium as jtedlium
from lhotse_tpu.recipes import tedlium2 as jtedlium2
from lhotse_tpu.recipes import timit as jtimit
from lhotse_tpu.recipes import voxceleb as jvox
from lhotse_tpu.recipes import yesno as jyesno
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import aishell as paishell
from lhotse_tpu_torch.recipes import aishell2 as paishell2
from lhotse_tpu_torch.recipes import librilight as plibrilight
from lhotse_tpu_torch.recipes import mls as pmls
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import peoples_speech as ppeoples
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.recipes import spgispeech as pspgi
from lhotse_tpu_torch.recipes import tedlium as ptedlium
from lhotse_tpu_torch.recipes import tedlium2 as ptedlium2
from lhotse_tpu_torch.recipes import timit as ptimit
from lhotse_tpu_torch.recipes import voxceleb as pvox
from lhotse_tpu_torch.recipes import yesno as pyesno
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_device_augment import _JaxKernelRoute
from test_torch_recipes_noise import (
    AUG_TOL, EXTRACTOR_TOL, _decompressed, musan_tree, noise_pool, rir_noise_tree, seeded_rir)

SR = 16000


def _noise(seconds, seed, sr=SR, channels=1):
    """tests/test_recipes*.py::_wav's signal: 0.1 white noise from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(channels, int(seconds * sr)) * 0.1).astype(np.float32)


def _wav(path, seconds=1.0, sr=SR, seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, _noise(seconds, seed, sr), sr)


def _flac(path, seconds=1.0, sr=SR, seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_flac(path, _noise(seconds, seed, sr), sr)


def _sph(path, seconds=1.0, sr=SR, seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_sph(str(path), _noise(seconds, seed, sr)[0], sr)


def _dicts(manifests):
    """Nested manifest dicts as plain dicts; a tuple of manifests (VoxCeleb's
    trial pairs) as a list; manifest items as ``to_dict()``."""
    if isinstance(manifests, dict):
        return {k: _dicts(v) for k, v in manifests.items()}
    if isinstance(manifests, tuple):
        return [_dicts(m) for m in manifests]
    return [item.to_dict() for item in manifests]


def _same(ours, theirs, tmp_path):
    assert _dicts(ours) == _dicts(theirs)
    written = _decompressed(tmp_path / "ours")
    assert written and written == _decompressed(tmp_path / "jax")
    return written


def _both(tmp_path, ours, theirs, *args, **kwargs):
    """Each package's ``prepare_*`` on the same arguments, into output
    directories of their own; the returns and the written files equal."""
    mine = ours(*args, output_dir=tmp_path / "ours", **kwargs)
    written = _same(mine, theirs(*args, output_dir=tmp_path / "jax", **kwargs), tmp_path)
    return mine, written


# -- the JAX tests' layouts ---------------------------------------------------------------


def yesno_tree(root, layout="recipes"):
    """``recipes``: tests/test_recipes.py:16 (two files); ``tranche6``:
    tests/test_recipes_tranche6.py:65 (31 bit patterns of 0.5 s); 8 kHz WAV."""
    root.mkdir(parents=True, exist_ok=True)
    if layout == "recipes":
        for i, name in enumerate(["0_0_1_0_1_0_1_1", "1_1_0_1_0_1_0_0"]):
            _wav(root / f"{name}.wav", sr=8000, seed=i)
        return root
    names = sorted({"_".join(str((i >> k) & 1) for k in range(8)) for i in range(31)})
    for i, name in enumerate(names):
        _wav(root / f"{name}.wav", seconds=0.5, sr=8000, seed=i)
    return root


def aishell_tree(root, layout="recipes", n=8, seconds=(1.0, 2.0), seed=0):
    """``recipes``: tests/test_recipes.py:50 (fullwidth letters, an
    untranscribed file); ``tranche6``: tests/test_recipes_tranche6.py:24 (a
    transcript without audio); ``slice``: ``n`` tone bursts of ``seconds``
    over the three splits, two speakers each."""
    data = root / "data_aishell"
    (data / "transcript").mkdir(parents=True, exist_ok=True)
    if layout == "recipes":
        lines = ["BAC009S0002W0122 中 文 ｔｅｓｔ", "BAC009S0002W0123 你 好",
                 "BAC009S0003W0001 早 上 好"]
        _wav(data / "wav" / "train" / "S0002" / "BAC009S0002W0122.wav", seed=4)
        _wav(data / "wav" / "train" / "S0002" / "BAC009S0002W9999.wav", seed=9)
        _wav(data / "wav" / "dev" / "S0002" / "BAC009S0002W0123.wav", seed=5)
        _wav(data / "wav" / "test" / "S0003" / "BAC009S0003W0001.wav", seed=6)
    elif layout == "tranche6":
        lines = []
        for part, spk, utt in (("train", "S0002", "BAC009S0002W0122"),
                               ("train", "S0002", "BAC009S0002W0123"),
                               ("dev", "S0724", "BAC009S0724W0121"),
                               ("test", "S0764", "BAC009S0764W0121")):
            _wav(data / "wav" / part / spk / f"{utt}.wav")
            lines.append(f"{utt} 广州 市 汽车 限购")
        lines.append("BAC009S9999W0001 无 音频")
    else:
        rng = np.random.RandomState(seed)
        lines = []
        for i in range(n):
            part = ("train", "train", "dev", "test")[i % 4]
            spk = f"S{2 + i % 6:04d}"
            utt = f"BAC009{spk}W{i:04d}"
            m = int(rng.uniform(*seconds) * SR)
            t = np.arange(m) / SR
            x = 0.2 * np.sin(2 * np.pi * (150 + 20 * i) * t) + 0.01 * rng.randn(m)
            (data / "wav" / part / spk).mkdir(parents=True, exist_ok=True)
            write_wav(data / "wav" / part / spk / f"{utt}.wav", x[None].astype(np.float32), SR)
            lines.append(f"{utt} 甚至 出现 交易 几乎 停滞 的 情况")
    (data / "transcript" / "aishell_transcript_v0.8.txt").write_text(
        "\n".join(lines) + "\n", encoding="utf-8")
    return root


def aishell2_tree(root):
    """tests/test_recipes_tranche2.py:280, and a second train speaker whose
    transcript carries fullwidth letters, a CJK apostrophe and a hyphen."""
    ios = root / "AISHELL-2" / "iOS"
    for part, root_name, seed in (("train", "data", 60), ("dev", "dev", 61), ("test", "test", 62)):
        split = ios / root_name
        utt = f"I{part}0001W0001"
        _wav(split / "wav" / f"S{seed}" / f"{utt}.wav", seed=seed)
        lines = [f"{utt}\t你好 世界"]
        if part == "train":
            _wav(split / "wav" / "S63" / "Itrain0002W0002.wav", seed=63)
            lines.append("Itrain0002W0002\tＡＴＭ机 好'的 it's e-mail，")
        (split / "trans.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root


def tedlium_tree(root, layout="tranche5", talks=None):
    """``tranche5``: tests/test_recipes_tranche5.py:104 (SPHERE talks of
    4 s, dev one, test two); ``slice``: ``talks`` {split: [(talk, seconds)]}
    of tone bursts, STM segments of 1-2 s with a ``{NOISE}`` and an
    ``ignore_time_segment_in_scoring`` line."""
    if layout == "tranche5":
        for split, names in (("dev", ["TalkA"]), ("test", ["TalkB", "TalkC"])):
            for t, talk in enumerate(names):
                _sph(root / "legacy" / split / "sph" / f"{talk}.sph", 4.0, seed=t)
                (root / "legacy" / split / "stm").mkdir(parents=True, exist_ok=True)
                (root / "legacy" / split / "stm" / f"{talk}.stm").write_text(
                    f"{talk} 1 {talk}_spk 0.50 2.00 <o,f0,male> hello there\n"
                    f"{talk} 1 {talk}_spk 2.10 3.80 <o,f0,male> general kenobi\n")
        return root
    rng = np.random.RandomState(7)
    for split, names in talks.items():
        for t, (talk, seconds) in enumerate(names):
            n = int(seconds * SR)
            x = 0.2 * np.sin(2 * np.pi * (170 + 30 * t) * np.arange(n) / SR) + 0.01 * rng.randn(n)
            (root / "legacy" / split / "sph").mkdir(parents=True, exist_ok=True)
            write_sph(str(root / "legacy" / split / "sph" / f"{talk}.sph"), x.astype(np.float32),
                      SR)
            lines, start = [], 0.2
            while start + 2.0 < seconds:
                end = round(start + rng.uniform(1.0, 2.0), 2)
                words = "they 're here {NOISE} now" if len(lines) == 1 else "general kenobi"
                if len(lines) == 2:
                    words = "ignore_time_segment_in_scoring"
                lines.append(f"{talk} 1 {talk} {start:.2f} {end:.2f} <o,f0,male> {words}")
                start = round(end + 0.1, 2)
            (root / "legacy" / split / "stm").mkdir(parents=True, exist_ok=True)
            (root / "legacy" / split / "stm" / f"{talk}.stm").write_text("\n".join(lines) + "\n")
    return root


def tedlium2_tree(root, layout="tranche2"):
    """``tranche2``: tests/test_recipes_tranche2.py:387 (WAV data behind
    ``.sph`` names, which the audio backends read as WAV); ``sphere``: the
    same as NIST SPHERE."""
    for part in ("train", "dev", "test"):
        path = root / part / "sph" / "TalkA.sph"
        (_wav if layout == "tranche2" else _sph)(path, seconds=3.0, seed=82)
        (root / part / "stm").mkdir(parents=True, exist_ok=True)
        (root / part / "stm" / "TalkA.stm").write_text(
            "TalkA 1 TalkA_spk 0.00 2.50 <o,f0,male> hello world\n"
            "TalkA 1 TalkA_spk 2.50 2.90 <o,f0,male> ignore_time_segment_in_scoring\n")
    return root


def librilight_tree(root):
    """tests/test_recipes_tranche2.py:237, and a second speaker's book in the
    ``small`` subset and a file in ``medium``."""
    for rel, seconds, seed, vad in (
            ("small/100/book1/chapter1", 2.0, 41, [[0.1, 0.9], [1.2, 1.8]]),
            ("small/200/book7/chapter3", 1.5, 42, [[0.0, 1.4]]),
            ("medium/300/book2/chapter9", 1.0, 43, [[0.25, 0.75]])):
        flac = root / f"{rel}.flac"
        _flac(flac, seconds=seconds, seed=seed)
        flac.with_suffix(".json").write_text(
            json.dumps({"speaker": rel.split("/")[1], "voice_activity": vad}))
    return root


def mls_tree(root, codec="flac"):
    """tests/test_recipes.py:128 (Polish, a speaker per split's utterance):
    ``flac`` writes ``mls_polish``, ``opus`` writes ``mls_polish_opus`` (48 kHz
    Opus, as MLS ships it), ``both`` writes the two."""
    from lhotse_tpu.audio.syscodecs import opus_encode

    for name in {"flac": ["mls_polish"], "opus": ["mls_polish_opus"],
                 "both": ["mls_polish", "mls_polish_opus"]}[codec]:
        lang_dir = root / name
        lang_dir.mkdir(parents=True)
        (lang_dir / "metainfo.txt").write_text("1234 | F | train | 10.5\n5678 | M | dev | 3.0\n")
        for split in ("train", "dev", "test"):
            audio_dir = lang_dir / split / "audio" / "1234" / "5678"
            audio_dir.mkdir(parents=True)
            if name.endswith("opus"):
                audio = _noise(1.0, 1, sr=48000)
                (audio_dir / f"1234_5678_{split}.opus").write_bytes(opus_encode(audio, 48000))
            else:
                write_flac(audio_dir / f"1234_5678_{split}.flac", _noise(1.0, 1), SR)
            (lang_dir / split / "transcripts.txt").write_text(f"1234_5678_{split}\tdzien dobry\n")
    return root


def peoples_speech_tree(root):
    """tests/test_recipes.py:621, and a ``test/test`` part of two
    utterances of one session."""
    _wav(root / "train" / "clean" / "some" / "session" / "utt0.wav", seed=96)
    (root / "train" / "clean.json").write_text(json.dumps({
        "identifier": "session-xyz",
        "training_data": {"name": ["utt0"], "label": ["hello people"],
                          "audio_document_id": ["some/session/utt0.wav"]}}) + "\n")
    for k in range(2):
        _flac(root / "test" / "test" / "doc" / f"seg{k}.flac", seconds=0.5 + k, seed=97 + k)
    (root / "test" / "test.json").write_text(json.dumps({
        "identifier": "doc-7",
        "training_data": {"name": ["seg0", "seg1"], "label": ["one two", "three"],
                          "audio_document_id": ["doc/seg0.flac", "doc/seg1.flac"]}}) + "\n")
    return root


def spgispeech_tree(root):
    """tests/test_recipes.py:536 (a row without audio), and a second call of
    the ``train`` split."""
    for part in ("train", "val"):
        _wav(root / part / "07a785e9" / "1.wav", seed=90)
        rows = ["07a785e9/1.wav|32044|Hello, World!", "07a785e9/2.wav|32044|missing audio"]
        if part == "train":
            _wav(root / part / "b1c2d3e4" / "4.wav", seconds=0.5, seed=91)
            rows.append("b1c2d3e4/4.wav|16044|It's Q3: revenue's up 5%.")
        (root / f"{part}.csv").write_text(
            "wav_filename|wav_filesize|transcript\n" + "\n".join(rows) + "\n")
    return root


def timit_tree(root, layout="recipes"):
    """``recipes``: tests/test_recipes.py:278 (WAV data behind ``.WAV``,
    phones h#/sh/ix/axr); ``tranche7``: tests/test_recipes_tranche7.py:72
    (NIST SPHERE behind ``.WAV``, as TIMIT ships it)."""
    if layout == "recipes":
        for part, spk, name, seed in (("TRAIN", "mabc0", "SI1", 30), ("TEST", "fadg0", "SI2", 31),
                                      ("TEST", "fdhc0", "SI3", 32)):
            d = root / "data" / part / "DR1" / spk
            _wav(d / f"{name}.WAV", seed=seed)
            (d / f"{name}.TXT").write_text("0 16000 she had your dark suit\n")
            (d / f"{name}.WRD").write_text("0 8000 she\n8000 16000 had\n")
            (d / f"{name}.PHN").write_text(
                "0 4000 h#\n4000 8000 sh\n8000 12000 ix\n12000 16000 axr\n")
        return root
    n = SR
    for part, dr, spk in (("TRAIN", "DR1", "fcjf0"), ("TEST", "DR1", "fadg0"),
                          ("TEST", "DR2", "fdhc0")):
        d = root / "data" / part / dr / spk
        _sph(d / "SA1.WAV")
        (d / "SA1.TXT").write_text(f"0 {n} she had your dark suit\n")
        (d / "SA1.WRD").write_text(f"0 {n // 2} she\n{n // 2} {n} had\n")
        (d / "SA1.PHN").write_text(f"0 {n // 4} sh\n{n // 4} {n // 2} iy\n{n // 2} {n} hh\n")
    return root


def voxceleb1_tree(root, layout="tranche10"):
    """``recipes``: tests/test_recipes.py:308 (two dev speakers, a test
    speaker, a negative trial against a train recording); ``tranche10``:
    tests/test_recipes_tranche10.py:19 (a trial of an unknown speaker; the
    JAX test seeds each file with ``hash()``, which varies per process:
    here each file takes its index). Returns the corpus and its trials
    list."""
    if layout == "recipes":
        speakers = {"id10001": "dev", "id10002": "dev", "id10270": "test"}
        meta = ["VoxCeleb1 ID\tVGGFace1 ID\tGender\tNationality\tSet"]
        for i, (spk, split) in enumerate(speakers.items()):
            meta.append(f"{spk}\tName_{spk}\t{'m' if i % 2 == 0 else 'f'}\tUSA\t{split}")
            for j in range(2):
                _wav(root / "wav" / spk / "sessA" / f"{j:05d}.wav", seed=40 + 2 * i + j)
        trials = ["1 id10270/sessA/00000.wav id10270/sessA/00001.wav",
                  "0 id10270/sessA/00000.wav id10001/sessA/00000.wav"]
    else:
        for k, (spk, sess, utt) in enumerate((
                ("id10001", "sess1", "00001"), ("id10001", "sess1", "00002"),
                ("id10270", "x6uY", "00001"), ("id10270", "x6uY", "00002"),
                ("id10271", "zzz1", "00001"))):
            _wav(root / "wav" / spk / sess / f"{utt}.wav", seconds=0.5, seed=k)
        meta = ["ID\tName\tGender\tNationality\tSet", "id10001\tA_Speaker\tf\tIreland\tdev",
                "id10270\tB_Speaker\tm\tUSA\ttest", "id10271\tC_Speaker\tf\tUK\ttest"]
        trials = ["1 id10270/x6uY/00001.wav id10270/x6uY/00002.wav",
                  "0 id10270/x6uY/00001.wav id10271/zzz1/00001.wav",
                  "1 id99999/none/00001.wav id10270/x6uY/00001.wav"]
    (root / "vox1_meta.csv").write_text("\n".join(meta) + "\n")
    (root / "trials.txt").write_text("\n".join(trials) + "\n")
    return root, root / "trials.txt"


# -- the recipes against JAX ---------------------------------------------------------------


@pytest.mark.parametrize("layout", ["recipes", "tranche6"])
def test_prepare_yesno_equals_jax(tmp_path, layout):
    root = yesno_tree(tmp_path / "waves_yesno", layout)
    ours, written = _both(tmp_path, pyesno.prepare_yesno, jyesno.prepare_yesno, root)
    assert set(ours) == {"train", "test"} and len(written) == 4
    names = sorted(p.stem for p in root.glob("*.wav"))
    assert [r.id for r in ours["train"]["recordings"]] == names[::2]
    assert all(set(s.text.split()) <= {"YES", "NO"} for s in ours["test"]["supervisions"])
    assert pyesno._WORD_MAP == jyesno._WORD_MAP


@pytest.mark.parametrize("layout", ["recipes", "tranche6", "slice"])
def test_prepare_aishell_equals_jax(tmp_path, layout):
    root = aishell_tree(tmp_path / "aishell", layout)
    ours, written = _both(tmp_path, paishell.prepare_aishell, jaishell.prepare_aishell, root)
    assert set(ours) == {"train", "dev", "test"} and len(written) == 6
    texts = [s.text for s in ours["train"]["supervisions"]]
    assert all(" " not in t for t in texts)
    if layout == "recipes":
        assert texts == ["中文TＥＳT"] and len(ours["train"]["recordings"]) == 1


def test_prepare_aishell2_equals_jax(tmp_path):
    root = aishell2_tree(tmp_path)
    ours, written = _both(tmp_path, paishell2.prepare_aishell2, jaishell2.prepare_aishell2, root)
    assert set(ours) == {"train", "dev", "test"} and len(written) == 6
    assert {s.speaker for s in ours["train"]["supervisions"]} == {"S60", "S63"}


@pytest.mark.parametrize("normalize_text", ["none", "upper", "kaldi"])
@pytest.mark.parametrize("parts", [("dev", "test"), "test"], ids=["dev+test", "test"])
def test_prepare_tedlium_equals_jax(tmp_path, parts, normalize_text):
    root = tedlium_tree(tmp_path / "TEDLIUM_release-3")
    ours, written = _both(tmp_path, ptedlium.prepare_tedlium, jtedlium.prepare_tedlium, root,
                          dataset_parts=parts, normalize_text=normalize_text)
    assert len(written) == 2 * len(ours)
    recs, sups = ours["test"]["recordings"], ours["test"]["supervisions"]
    assert len(recs) == 2 and len(sups) == 4
    assert recs[0].sources[0].source.endswith(".sph")
    assert ptedlium.TEDLIUM_PARTS == jtedlium.TEDLIUM_PARTS


def test_tedlium_stm_and_normalizer_equal_jax(tmp_path):
    """tests/test_recipes.py:92's STM file and normalizer strings."""
    stm = tmp_path / "TalkA.stm"
    stm.write_text(
        "TalkA 1 spk 0.00 2.50 <o,f0,male> hello {NOISE} world\n"
        "TalkA 1 spk 2.50 3.00 <o,f0,male> ignore_time_segment_in_scoring\n"
        "TalkA 1 spk 3.00 4.25 <o,f0,male> they 're here\n")
    for normalize in ("none", "upper", "kaldi"):
        ours = [s.to_dict() for s in ptedlium._parse_stm_file(stm, normalize)]
        assert ours == [s.to_dict() for s in jtedlium._parse_stm_file(stm, normalize)]
        assert len(ours) == 2
    for text in ("they 're [NOISE] here", "abc", "' cause <unk> it 's", "[LAUGH] we 've"):
        for mode in ("none", "upper", "kaldi"):
            assert (ptedlium.normalize_text_tedlium(text, mode)
                    == jtedlium.normalize_text_tedlium(text, mode))
    assert ptedlium.normalize_text_tedlium("they 're [NOISE] here", "kaldi") == "they're  here"
    for normalize in (ptedlium.normalize_text_tedlium, jtedlium.normalize_text_tedlium):
        with pytest.raises(ValueError):
            normalize("abc", "lower")


@pytest.mark.parametrize("layout", ["tranche2", "sphere"])
@pytest.mark.parametrize("normalize_text", ["none", "upper"])
def test_prepare_tedlium2_equals_jax(tmp_path, layout, normalize_text):
    root = tedlium2_tree(tmp_path / "TEDLIUM_release2", layout)
    ours, written = _both(tmp_path, ptedlium2.prepare_tedlium2, jtedlium2.prepare_tedlium2, root,
                          normalize_text=normalize_text)
    assert set(ours) == {"train", "dev", "test"} and len(written) == 6
    (sup,) = list(ours["train"]["supervisions"])
    assert sup.duration == 2.5
    assert ptedlium2.TEDLIUM2_PARTS == jtedlium2.TEDLIUM2_PARTS


@pytest.mark.parametrize("parts", ["auto", "small", ("small", "medium")])
def test_prepare_librilight_equals_jax(tmp_path, parts):
    root = librilight_tree(tmp_path / "librilight")
    ours, written = _both(tmp_path, plibrilight.prepare_librilight, jlibrilight.prepare_librilight,
                          root, dataset_parts=parts)
    assert len(written) == 2 * len(ours)
    assert sorted(ours) == (["small"] if parts == "small" else ["medium", "small"])
    assert len(ours["small"]["supervisions"]) == 3
    assert plibrilight.LIBRILIGHT == jlibrilight.LIBRILIGHT
    # A second run reads the cached manifests.
    again = plibrilight.prepare_librilight(root, dataset_parts=parts, output_dir=tmp_path / "ours")
    assert _dicts(again) == _dicts(ours)


@pytest.mark.parametrize("codec,opus", [("flac", False), ("opus", True), ("both", False),
                                        ("both", True)])
def test_prepare_mls_equals_jax(tmp_path, codec, opus):
    from lhotse_tpu.audio import syscodecs

    if codec != "flac" and not syscodecs.opus_available():
        pytest.skip("the system Opus and Ogg libraries are not present")
    root = mls_tree(tmp_path / "mls", codec)
    ours, written = _both(tmp_path, pmls.prepare_mls, jmls.prepare_mls, root, opus=opus)
    assert set(ours) == {"polish"} and set(ours["polish"]) == {"train", "dev", "test"}
    assert len(written) == 6
    rec = ours["polish"]["train"]["recordings"][0]
    assert rec.sampling_rate == SR and rec.sources[0].source.endswith(".opus" if opus else ".flac")
    (sup,) = list(ours["polish"]["train"]["supervisions"])
    assert sup.speaker == "1234" and sup.gender == "F" and sup.language == "polish"
    # A second run reads what the first wrote.
    again = pmls.prepare_mls(root, output_dir=tmp_path / "ours", opus=opus)
    assert _dicts(again) == _dicts(ours)


def test_prepare_peoples_speech_equals_jax(tmp_path):
    root = peoples_speech_tree(tmp_path / "peoples_speech")
    ours, written = _both(tmp_path, ppeoples.prepare_peoples_speech,
                          jpeoples.prepare_peoples_speech, root)
    assert set(ours) == {"train/clean", "test/test"} and len(written) == 4
    assert [s.custom["session_id"] for s in ours["test/test"]["supervisions"]] == ["doc-7"] * 2
    assert ppeoples.PEOPLES_SPEECH == jpeoples.PEOPLES_SPEECH
    again = ppeoples.prepare_peoples_speech(root, output_dir=tmp_path / "ours")
    assert _dicts(again) == _dicts(ours)
    theirs = jpeoples.prepare_peoples_speech(root, output_dir=tmp_path / "jax")
    assert _dicts(again) == _dicts(theirs)


@pytest.mark.parametrize("normalize_text", [True, False])
def test_prepare_spgispeech_equals_jax(tmp_path, normalize_text):
    root = spgispeech_tree(tmp_path / "spgispeech")
    ours, written = _both(tmp_path, pspgi.prepare_spgispeech, jspgi.prepare_spgispeech, root,
                          normalize_text=normalize_text)
    assert set(ours) == {"train", "val"} and len(written) == 4
    texts = [s.text for s in ours["train"]["supervisions"]]
    assert texts == (["hello world", "its q3 revenues up 5"] if normalize_text
                     else ["Hello, World!", "It's Q3: revenue's up 5%."])
    assert [s.id for s in ours["val"]["supervisions"]] == ["07a785e9_1"]


def test_spgispeech_normalize_and_worker_equal_jax(tmp_path):
    for text in ("Hello, World!", "It's Q3: revenue's up 5%.", "A-B (c) [d] {e} e.g. ~x"):
        assert pspgi.normalize(text) == jspgi.normalize(text)
    _wav(tmp_path / "07a785e9" / "1.wav", seed=3)
    ours = pspgi._audio_read_worker(tmp_path / "07a785e9" / "1.wav")
    assert ours.id == "07a785e9_1"
    assert ours.to_dict() == jspgi._audio_read_worker(tmp_path / "07a785e9" / "1.wav").to_dict()


@pytest.mark.parametrize("layout", ["recipes", "tranche7"])
@pytest.mark.parametrize("num_phones", [60, 48, 39])
def test_prepare_timit_equals_jax(tmp_path, layout, num_phones):
    root = timit_tree(tmp_path / "timit", layout)
    ours, written = _both(tmp_path, ptimit.prepare_timit, jtimit.prepare_timit, root,
                          num_phones=num_phones)
    assert set(ours) == {"TRAIN", "DEV", "TEST"} and len(written) == 6
    (sup,) = list(ours["TRAIN"]["supervisions"])
    assert [a.symbol for a in sup.alignment["word"]] == ["she", "had"]
    if layout == "recipes":
        assert [a.symbol for a in sup.alignment["phone"]] == {
            60: ["h#", "sh", "ix", "axr"], 48: ["sil", "sh", "ix", "er"],
            39: ["sil", "sh", "ih", "er"]}[num_phones]


def test_timit_tables_equal_jax():
    for n in (60, 48, 39):
        assert ptimit.get_phonemes(n) == jtimit.get_phonemes(n)
    assert ptimit.get_speakers() == jtimit.get_speakers()
    for get in (ptimit.get_phonemes, jtimit.get_phonemes):
        with pytest.raises(ValueError):
            get(61)


@pytest.mark.parametrize("layout", ["recipes", "tranche10"])
@pytest.mark.parametrize("with_trials", [True, False], ids=["trials", "no-trials"])
def test_prepare_voxceleb1_equals_jax(tmp_path, layout, with_trials):
    root, trials = voxceleb1_tree(tmp_path / "voxceleb1", layout)
    kwargs = dict(voxceleb1_root=root, trials_path=trials if with_trials else None)
    ours = pvox.prepare_voxceleb(output_dir=tmp_path / "ours", **kwargs)
    written = _same(ours, jvox.prepare_voxceleb(output_dir=tmp_path / "jax", **kwargs), tmp_path)
    assert len(written) == (8 if with_trials else 4)
    assert ("pos_trials" in ours) == with_trials
    if with_trials:
        pos1, pos2 = ours["pos_trials"]
        assert len(pos1) == len(pos2) == 1 and pos1[0].id == pos2[0].id
        assert isinstance(pos1[0], MonoCut)
        neg1, _ = ours["neg_trials"]
        assert len(neg1) == (0 if layout == "recipes" else 1)


def test_prepare_voxceleb_refuses_as_jax(tmp_path):
    """No root is a ValueError; VoxCeleb2's ``.m4a`` files need ``ffmpeg``,
    which neither package finds here, so both raise the same error."""
    import shutil

    for prepare in (pvox.prepare_voxceleb, jvox.prepare_voxceleb):
        with pytest.raises(ValueError):
            prepare()
    root = tmp_path / "voxceleb2"
    (root / "dev" / "aac" / "id00012" / "21Uxsk56VDQ").mkdir(parents=True)
    (root / "dev" / "aac" / "id00012" / "21Uxsk56VDQ" / "00001.m4a").write_bytes(b"\0" * 64)
    (root / "vox2_meta.csv").write_text("ID, VGGFace2 ID, Gender, Set\nid00012, n000012, m, dev\n")
    assert shutil.which("ffmpeg") is None
    errors = []
    for scan in (pvox._prepare_voxceleb_v2, jvox._prepare_voxceleb_v2):
        with pytest.raises(Exception) as info:
            scan(root, 1)
        errors.append((type(info.value).__name__, str(info.value).replace("lhotse_tpu_torch",
                                                                          "lhotse_tpu")))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("recipe", [
    "yesno", "aishell", "aishell2", "timit", "peoples_speech", "spgispeech", "mls"])
def test_prepare_refuses_a_missing_corpus_as_jax(tmp_path, recipe):
    ours = {"yesno": pyesno.prepare_yesno, "aishell": paishell.prepare_aishell,
            "aishell2": paishell2.prepare_aishell2, "timit": ptimit.prepare_timit,
            "peoples_speech": ppeoples.prepare_peoples_speech,
            "spgispeech": lambda c: pspgi.prepare_spgispeech(c, tmp_path / "o"),
            "mls": pmls.prepare_mls}[recipe]
    theirs = {"yesno": jyesno.prepare_yesno, "aishell": jaishell.prepare_aishell,
              "aishell2": jaishell2.prepare_aishell2, "timit": jtimit.prepare_timit,
              "peoples_speech": jpeoples.prepare_peoples_speech,
              "spgispeech": lambda c: jspgi.prepare_spgispeech(c, tmp_path / "j"),
              "mls": jmls.prepare_mls}[recipe]
    for prepare in (ours, theirs):
        with pytest.raises(AssertionError):
            prepare(tmp_path / "no-such-dir")


def test_text_normalizers_equal_jax():
    """AISHELL's and AISHELL-2's ``text_normalize`` on the JAX tests' strings
    and on fullwidth, CJK-apostrophe and contraction cases."""
    for text in ("中 文 ｔｅｓｔ", "ａｂｃｋｔ ｘｙｚ", "你 好"):
        assert paishell.text_normalize(text) == jaishell.text_normalize(text)
    assert paishell.text_normalize("中 文 ｔｅｓｔ") == "中 文 TＥＳT"
    for text in ("你好 世界", "ＡＴＭ机 好'的 it's e-mail，", "𫖯 what? 你'好",
                 "'lead"):
        assert paishell2.text_normalize(text) == jaishell2.text_normalize(text)
    assert paishell2.text_normalize("好'的 it's") == "好的 IT'S"


# -- the slice: AISHELL into the on-device chain, TED-LIUM into on-the-fly features ---------


def _bucketed(recordings, bucket=(2.0, 4)):
    """The utterances, sorted by id, as (B, T) float32 batches of at most
    ``bucket[1]`` rows with their lengths."""
    audio = [r.load_audio()[0] for r in sorted(recordings, key=lambda r: r.id)]
    out = []
    for i in range(0, len(audio), bucket[1]):
        rows = audio[i:i + bucket[1]]
        lens = np.array([len(x) for x in rows])
        batch = np.zeros((len(rows), lens.max()), np.float32)
        for k, x in enumerate(rows):
            batch[k, :len(x)] = x
        out.append((batch, lens))
    return out


def _aishell_recordings(prepare, root):
    made = prepare(root)
    return [r for part in ("train", "dev", "test") for r in made[part]["recordings"]]


def test_aishell_fed_augmenter_equals_jax(tmp_path):
    aishell = aishell_tree(tmp_path / "aishell", "slice", n=8)
    musan, rirs = musan_tree(tmp_path / "musan", "pool"), rir_noise_tree(tmp_path / "RIRS", 2)
    ours = _aishell_recordings(paishell.prepare_aishell, aishell)
    theirs = _aishell_recordings(jaishell.prepare_aishell, aishell)
    assert [r.to_dict() for r in ours] == [r.to_dict() for r in theirs] and len(ours) == 8
    pool = noise_pool(pmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"])
    rir = seeded_rir(prir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"])
    assert np.array_equal(
        pool, noise_pool(jmusan.prepare_musan(musan, parts="noise")["noise"]["recordings"]))
    assert np.array_equal(
        rir, seeded_rir(jrir.prepare_rir_noise(rirs, parts="real_rir")["real_rir"]["recordings"]))
    common = dict(speed_factor=1.1, noise_pool=pool, rir=rir, snr=(10, 20), mix_prob=0.5, seed=3)
    port = OnDeviceAugmenter([(2.0, 4)], wire_format="int16", specaugment=SpecAugment(seed=7),
                             device="cpu", **common)
    jax_aug = JAugmenter([(2.0, 4)], wire_format="int16", specaugment=JSpecAugment(seed=7),
                         fbank=_JaxKernelRoute(), **common)
    batches = _bucketed(ours)
    for (audio, lens), (jaudio, jlens) in zip(batches, _bucketed(theirs)):
        assert np.array_equal(audio, jaudio) and np.array_equal(lens, jlens)
    assert [len(lens) for _, lens in batches] == [4, 4]
    mixed = 0
    for audio, lens in batches:
        s_ours, s_theirs = port.stage(audio, lens), jax_aug.stage(audio, lens)
        mixed += int(np.asarray(s_ours.kwargs["mix_mask"]).sum())
        feats, feat_lens = port.compute(s_ours)
        jfeats, jlens = jax_aug.compute(s_theirs)
        assert tuple(feats.shape) == np.asarray(jfeats).shape == (4, 182, 80)
        assert np.array_equal(feat_lens.numpy(), np.asarray(jlens))
        np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=AUG_TOL)
    assert mixed > 0  # the MUSAN pool went into some rows


TALKS = {"train": [("TalkA", 9.0), ("TalkB", 7.0)], "dev": [("TalkC", 6.0)]}


def _tedlium_batches(pkg, root):
    """Each package's TED-LIUM chain: ``prepare_tedlium`` → the cuts of every
    split → ``trim_to_supervisions`` → ``K2SpeechRecognitionDataset`` with
    ``OnTheFlyFeatures``, four cuts per batch."""
    if pkg == "port":
        made = ptedlium.prepare_tedlium(root, dataset_parts=("train", "dev"))
        CS, seed_fn, dataset = CutSet, fix_random_seed, K2SpeechRecognitionDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))))
    else:
        made = jtedlium.prepare_tedlium(root, dataset_parts=("train", "dev"))
        # The JAX extractors' device route, in XLA on the CPU.
        CS, seed_fn, dataset = J.CutSet, jfix, JDataset(
            return_cuts=True, input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))))
    seed_fn(0)
    cuts = [c for split in ("train", "dev") for c in CS.from_manifests(
        **made[split]).trim_to_supervisions().to_eager()]
    return [dataset[CS.from_cuts(cuts[i:i + 4])] for i in range(0, len(cuts), 4)]


def test_tedlium_on_the_fly_equals_jax(tmp_path):
    root = tedlium_tree(tmp_path / "TEDLIUM_release-3", "slice", talks=TALKS)
    ours, theirs = _tedlium_batches("port", root), _tedlium_batches("jax", root)
    assert len(ours) == len(theirs) >= 2
    texts = []
    for a, b in zip(ours, theirs):
        assert a["inputs"].shape == b["inputs"].shape and np.isfinite(a["inputs"]).all()
        np.testing.assert_allclose(a["inputs"], b["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        for key in ("sequence_idx", "start_frame", "num_frames"):
            np.testing.assert_array_equal(a["supervisions"][key], b["supervisions"][key])
        assert a["supervisions"]["text"] == b["supervisions"]["text"]
        assert [c.to_dict() for c in a["supervisions"]["cut"]] == [
            c.to_dict() for c in b["supervisions"]["cut"]]
        texts += a["supervisions"]["text"]
    assert "they 're here [NOISE] now" in texts
    assert not any("ignore_time_segment" in t for t in texts)
    # Every STM segment but the ignored ones became a cut.
    assert len(texts) == sum(
        len(SupervisionSet.from_segments(ptedlium._parse_stm_file(p)))
        for p in root.rglob("*.stm"))
    assert RecordingSet.from_dir(root, "*.sph").duration("TalkA") == 9.0
