"""
The port's TTS, accented-speech and children's corpus recipes
(lhotse_tpu_torch.recipes ``hifitts``, ``ears``, ``daily_talk``,
``cmu_arctic``, ``cmu_indic``, ``l2_arctic``, ``cmu_kids``, ``cslu_kids``,
``adept``, ``grid`` and ``oto_speech``) against the JAX package's, on the
fixture layouts of tests/test_recipes_tranche2.py:24,43,61,111,447,528,544,
tests/test_recipes_tranche3.py:423,515,535 and tests/test_recipes_tranche4.py:283
(made from the same numpy seeds), and on wider layouts of the same formats:
Hi-Fi TTS over several partitions (and a cached re-run with one partition
missing), EARS with a missing speaker and an untranscribed utterance (and
a cached re-run), DailyTalk dialogues, CMU ARCTIC with an unannotated
speaker and a prompt without a recording, CMU Indic in two scripts with a
line that ends in whitespace, L2-ARCTIC's read and suitcase parts, CMU Kids
as real SPHERE with ``NA`` grades and ages (absolute and relative paths),
CSLU Kids with its noise tags kept and stripped, ADEPT with a type that
has no interpretations, GRID with and without supervisions at one and two
jobs, otoSpeech over two parts of two shards each (reused on the second
run). Also the JAX fault the port keeps out (a CMU ARCTIC prompt without
a recording, ROADMAP C2), the JAX behaviours it keeps (CSLU Kids' two
file-name prefixes, L2-ARCTIC on a stray ``.txt``, DailyTalk's speaker
check), the
downloads left out, the ``prepare`` commands through both CLIs, and the
slice at a small size: CMU Kids utterances through each package's
``OnDeviceAugmenter`` (within ``AUG_TOL`` of the JAX augmenter with its
fbank layer's kernel route in float64).
"""
import json
import tarfile

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.sphio import write_sph
from lhotse_tpu.dataset.device_augment import OnDeviceAugmenter as JAugmenter
from lhotse_tpu.dataset.signal_transforms import SpecAugment as JSpecAugment
from lhotse_tpu.recipes import adept as jadept
from lhotse_tpu.recipes import cmu_arctic as jarctic
from lhotse_tpu.recipes import cmu_indic as jindic
from lhotse_tpu.recipes import cmu_kids as jkids
from lhotse_tpu.recipes import cslu_kids as jcslu
from lhotse_tpu.recipes import daily_talk as jdaily
from lhotse_tpu.recipes import ears as jears
from lhotse_tpu.recipes import grid as jgrid
from lhotse_tpu.recipes import hifitts as jhifitts
from lhotse_tpu.recipes import l2_arctic as jl2
from lhotse_tpu.recipes import musan as jmusan
from lhotse_tpu.recipes import oto_speech as joto
from lhotse_tpu.recipes import rir_noise as jrir
from lhotse_tpu.recipes.utils import read_manifests_if_cached as jread_cached
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
from lhotse_tpu_torch.recipes import adept as padept
from lhotse_tpu_torch.recipes import cmu_arctic as parctic
from lhotse_tpu_torch.recipes import cmu_indic as pindic
from lhotse_tpu_torch.recipes import cmu_kids as pkids
from lhotse_tpu_torch.recipes import cslu_kids as pcslu
from lhotse_tpu_torch.recipes import daily_talk as pdaily
from lhotse_tpu_torch.recipes import ears as pears
from lhotse_tpu_torch.recipes import grid as pgrid
from lhotse_tpu_torch.recipes import hifitts as phifitts
from lhotse_tpu_torch.recipes import l2_arctic as pl2
from lhotse_tpu_torch.recipes import musan as pmusan
from lhotse_tpu_torch.recipes import oto_speech as poto
from lhotse_tpu_torch.recipes import rir_noise as prir
from lhotse_tpu_torch.recipes.utils import read_manifests_if_cached
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_recipes_asr import _dicts
from test_torch_recipes_asr_corpora import _flac, _sig, _wav, _words
from test_torch_recipes_noise import AUG_TOL, musan_tree, noise_pool, rir_noise_tree, seeded_rir
from test_torch_recipes_overlap import _files
from test_torch_recipes_zh import _JaxKernelRoute64, _bucketed

SR = 16000
ENGLISH = ("the", "dog", "ran", "away", "author", "of", "danger", "trail", "put", "red", "at",
           "now", "please", "blue", "green", "soon", "hello", "world")
BENGALI = ("বাংলা", "বাক্য", "আমি", "তুমি", "ভালো", "আছি")
TELUGU = ("తెలుగు", "వాక్యం", "నేను", "మీరు", "బాగున్నాను")


def _txt(path, text, encoding="utf-8"):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text, encoding=encoding)
    return path


def _seconds(rng, lo=1.0, hi=3.0):
    return round(float(rng.uniform(lo, hi)), 2)


# -- the layouts -----------------------------------------------------------------------------


def hifitts_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche2.py:447 (one 44.1 kHz clip of
    speaker 92's clean train partition); ``wide``: speakers 92 and 6670
    ``clean`` and 6097 ``other``, each with a train, dev and test manifest
    of 2 clips of 1-2 s at 44.1 kHz."""
    if layout == "jaxtest":
        _wav(root / "audio" / "book1" / "utt1.wav", sr=44100, seed=88)
        row = {"audio_filepath": "audio/book1/utt1.wav", "text": "hello world",
               "text_normalized": "Hello, world!", "duration": 1.0}
        _txt(root / "92_manifest_clean_train.json", json.dumps(row) + "\n")
        return (root,), {}
    rng, k = np.random.RandomState(seed), 0
    for spk, quality in (("92", "clean"), ("6670", "clean"), ("6097", "other")):
        for split in ("train", "dev", "test"):
            rows = []
            for i in range(2):
                k += 1
                rel = f"audio/{spk}_{quality}/book{k % 3}/utt_{spk}_{split}_{i}.wav"
                _wav(root / rel, _seconds(rng, 1.0, 2.0), seed=seed + k, sr=44100)
                text = _words(rng, ENGLISH)
                rows.append(json.dumps({"audio_filepath": rel, "text": text,
                                        "text_normalized": text.capitalize() + ".",
                                        "duration": 1.0}))
            _txt(root / f"{spk}_manifest_{quality}_{split}.json", "\n".join(rows) + "\n")
    return (root,), {}


def ears_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche2.py:544 (one 48 kHz utterance of
    p001); ``wide``: speakers p001, p002 and p005 (p003 and p004 missing)
    with 3 read utterances each at 48 kHz and a free-speech utterance that
    ``transcripts.json`` does not hold, and metadata beyond the gender."""
    if layout == "jaxtest":
        _wav(root / "p001" / "emo_adoration_sentences.wav", sr=48000, seed=93)
        _txt(root / "speaker_statistics.json",
             json.dumps({"p001": {"gender": "female", "age": "18-25"}}))
        _txt(root / "transcripts.json",
             json.dumps({"emo_adoration_sentences": "You're just the sweetest."}))
        return (root,), {}
    rng, meta, texts, k = np.random.RandomState(seed), {}, {}, 0
    styles = ("emo_anger_sentences", "read_fast", "rainbow_01_regular")
    for spk, gender in (("p001", "female"), ("p002", "male"), ("p005", "female")):
        meta[spk] = {"gender": gender, "age": "26-35", "ethnicity": "white or caucasian",
                     "native language": "american english", "height": "170 cm"}
        for style in styles + ("freeform_speech_01",):
            k += 1
            _wav(root / spk / f"{style}.wav", _seconds(rng), seed=seed + k, sr=48000)
    for style in styles:
        texts[style] = _words(rng, ENGLISH).capitalize() + "."
    _txt(root / "speaker_statistics.json", json.dumps(meta))
    _txt(root / "transcripts.json", json.dumps(texts))
    return (root,), {}


def daily_talk_tree(root, layout="wide", seed=0, speaker_index=None):
    """``jaxtest``: tests/test_recipes_tranche2.py:111 (one dialogue of two
    turns); ``wide``: 3 dialogues of 3 turns at 44.1 kHz, in the release's
    ``data/<dialog>/<utt>_<speaker>_d<dialog>.wav`` layout. With
    ``speaker_index``, the last turn's speaker is that index."""
    if layout == "jaxtest":
        _wav(root / "data" / "0" / "0_0_d0.wav", seed=11)
        _wav(root / "data" / "0" / "1_1_d0.wav", seed=12)
        meta = {"0": {
            "0": {"index": 0, "text": "hi there", "speaker": 0, "turn": 0, "topic": "greeting",
                  "emotion": "none", "act": "inform"},
            "1": {"index": 1, "text": "hello", "speaker": 1, "turn": 1, "topic": "greeting",
                  "emotion": "none", "act": "inform"}}}
        _txt(root / "metadata.json", json.dumps(meta))
        return (root,), {}
    rng, meta, index = np.random.RandomState(seed), {}, 0
    for d in range(3):
        meta[str(d)] = {}
        for u in range(3):
            spk = u % 2
            _wav(root / "data" / str(d) / f"{u}_{spk}_d{d}.wav", _seconds(rng), seed + index,
                 sr=44100)
            meta[str(d)][str(u)] = {
                "index": index, "text": _words(rng, ENGLISH), "speaker": spk, "turn": u,
                "topic": ("ordinary_life", "work", "relationship")[d],
                "emotion": ("no emotion", "happiness", "surprise")[u],
                "act": ("inform", "question", "directive")[u]}
            index += 1
    if speaker_index is not None:
        meta["2"]["2"]["speaker"] = speaker_index
    _txt(root / "metadata.json", json.dumps(meta))
    return (root,), {}


def cmu_arctic_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche2.py:24 (bdl, two prompts);
    ``wide``: bdl and aew (no documented gender or accent), 4 utterances
    each; ``unrecorded``: ``wide`` with a prompt of aew that has no
    recording."""
    if layout == "jaxtest":
        pkg = root / "cmu_us_bdl_arctic"
        _wav(pkg / "wav" / "arctic_a0001.wav", seed=1)
        _wav(pkg / "wav" / "arctic_a0002.wav", seed=2)
        _txt(pkg / "etc" / "txt.done.data", '( arctic_a0001 "Author of the danger trail." )\n'
             '( arctic_a0002 "Philip Steels etc." )\n')
        return (root,), {}
    rng, k = np.random.RandomState(seed), 0
    for spk in ("bdl", "aew"):
        pkg, lines = root / f"cmu_us_{spk}_arctic", []
        for utt in ("arctic_a0001", "arctic_a0002", "arctic_b0001", "arctic_b0539"):
            k += 1
            _wav(pkg / "wav" / f"{utt}.wav", _seconds(rng), seed + k)
            lines.append(f'( {utt} "{_words(rng, ENGLISH).capitalize()}." )')
        if spk == "aew" and layout == "unrecorded":
            lines.append('( arctic_b0540 "A prompt nobody recorded." )')
        _txt(pkg / "etc" / "txt.done.data", "\n".join(lines) + "\n")
    return (root,), {}


def cmu_indic_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche3.py:515 (ben_rm, one Bengali and
    one arctic prompt, ``voice.feats`` with an age); ``wide``: ben_rm and
    tel_ss (no ``voice.feats``), 3 prompts in the speaker's script and 2
    arctic prompts each; one Telugu line ends in spaces."""
    if layout == "jaxtest":
        pkg = root / "cmu_indic_ben_rm"
        _wav(pkg / "wav" / "ben_0001.wav", seed=46)
        _wav(pkg / "wav" / "arctic_a0001.wav", seed=47)
        _txt(pkg / "etc" / "txt.done.data",
             '( ben_0001 "বাংলা বাক্য" )\n( arctic_a0001 "An English prompt." )\n')
        _txt(pkg / "etc" / "voice.feats", "name x\nage 34\n")
        return (root,), {}
    rng, k = np.random.RandomState(seed), 0
    for spk, lang, words in (("ben_rm", "ben", BENGALI), ("tel_ss", "tel", TELUGU)):
        pkg, lines = root / f"cmu_indic_{spk}", []
        for utt in (f"{lang}_0001", f"{lang}_0002", f"{lang}_0003", "arctic_a0001",
                    "arctic_a0002"):
            k += 1
            _wav(pkg / "wav" / f"{utt}.wav", _seconds(rng), seed + k)
            text = _words(rng, words if "arctic" not in utt else ENGLISH)
            lines.append(f'( {utt} "{text}" )' + ("   " if utt == "tel_0002" else ""))
        _txt(pkg / "etc" / "txt.done.data", "\n".join(lines) + "\n")
        if spk == "ben_rm":
            _txt(pkg / "etc" / "voice.feats", "name ben_rm\nage 29\n")
    return (root,), {}


def l2_arctic_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche2.py:43 (aba, one read utterance
    and the suitcase part); ``wide``: the release's upper-case speaker
    directories ABA, BWC, HJK and YKWK with 3 read utterances each at 44.1
    kHz, and the suitcase part for ABA and HJK."""
    if layout == "jaxtest":
        spk = root / "aba"
        _wav(spk / "wav" / "arctic_a0001.wav", seed=3)
        _txt(spk / "transcript" / "arctic_a0001.txt", "Author of the danger trail.")
        _wav(root / "suitcase_corpus" / "wav" / "aba.wav", seed=4)
        _txt(root / "suitcase_corpus" / "transcript" / "aba.txt", "free talk")
        return (root,), {}
    rng, k = np.random.RandomState(seed), 0
    for spk in ("ABA", "BWC", "HJK", "YKWK"):
        for utt in ("arctic_a0001", "arctic_a0002", "arctic_b0003"):
            k += 1
            _wav(root / spk / "wav" / f"{utt}.wav", _seconds(rng), seed + k, sr=44100)
            _txt(root / spk / "transcript" / f"{utt}.txt", _words(rng, ENGLISH) + "\n")
    for spk in ("aba", "hjk"):
        k += 1
        _wav(root / "suitcase_corpus" / "wav" / f"{spk}.wav", _seconds(rng, 3.0, 5.0), seed + k,
             sr=44100)
        _txt(root / "suitcase_corpus" / "transcript" / f"{spk}.txt", _words(rng, ENGLISH, 6, 12))
    return (root,), {}


KIDS_SPEAKERS = (("fabc", "SUM95", "3/9"), ("mdef", "SUM95", "NA/NA"),
                 ("fghi", "SUM96", "K/NA"), ("mjkl", "SUM96", "NA/7"))


def cmu_kids_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche2.py:61 (one WAV utterance behind
    a ``.sph`` name); ``wide``: the LDC97S63 tables (two header lines in
    ``speaker.tbl``, ``NA`` grades and ages) and 4 speakers of both sexes
    reading 4 prompts each, in bins 1 and 2, as 16 kHz int16 SPHERE of 1-3
    s. Returns the corpus, as ``cmu_kids/`` (the recipe takes its parent)."""
    if layout == "jaxtest":
        tables = root / "cmu_kids" / "tables"
        _txt(tables / "sentence.tbl", "ab1\t5\tThe dog ran away.\n")
        _txt(tables / "speaker.tbl", "header1\nheader2\n" "fabc\tSUM96\t3/9\tx\ty\n")
        _txt(tables / "transcrp.tbl", "fabcab11 the dog ran away\n")
        _wav(root / "cmu_kids" / "kids" / "fabc" / "signal" / "fabcab11.sph", seed=5)
        return (root,), {}
    rng, kids = np.random.RandomState(seed), root / "cmu_kids"
    prompts = {f"{c}{n}": _words(rng, ENGLISH).capitalize() + "." for c in ("ab", "cd")
               for n in (1, 2)}
    _txt(kids / "tables" / "sentence.tbl",
         "".join(f"{u}\t{k + 1}\t{t}\n" for k, (u, t) in enumerate(prompts.items())))
    _txt(kids / "tables" / "speaker.tbl", "SPEAKER\tPOP\tGR/AGE\tSEX\tDIALECT\n\n" + "".join(
        f"{s}\t{p}\t{g}\t{s[0].upper()}\tPittsburgh\n" for s, p, g in KIDS_SPEAKERS))
    rows, k = [], 0
    for spk, _, _ in KIDS_SPEAKERS:
        for utt, text in prompts.items():
            k += 1
            tbin = 1 + (k % 3 == 0)
            trn = f"{spk}{utt}{tbin}"
            spoken = text.lower().rstrip(".") + (" [noise]" if tbin == 2 else "")
            rows.append(f"{trn} {spoken}")
            path = kids / "kids" / spk / "signal" / f"{trn}.sph"
            path.parent.mkdir(parents=True, exist_ok=True)
            write_sph(str(path), _sig(_seconds(rng), seed + k), SR)
    _txt(kids / "tables" / "transcrp.tbl", "\n".join(rows) + "\n")
    return (kids,), {}


def cslu_kids_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche3.py:535 (one scripted and one
    spontaneous utterance); ``wide``: 4 speakers of grades 0-4 reading 2
    scripted prompts each (one without a verification label) and telling 1
    spontaneous story with noise tags, ``docs/all.map`` and
    ``docs/<prompt>-verified.txt``."""
    if layout == "jaxtest":
        _wav(root / "speech" / "scripted" / "00" / "0" / "ks001" / "ks001000.wav", seed=48)
        _wav(root / "speech" / "spontaneous" / "01" / "0" / "ks002" / "ks002xx0.wav", seed=49)
        _txt(root / "docs" / "all.map", '00 "the word"\n01 "ignored"\n')
        _txt(root / "docs" / "00-verified.txt", "x/ks001000.wav 1\n")
        _txt(root / "trans" / "spontaneous" / "01" / "0" / "ks002" / "ks002xx0.txt",
             "hello <bn> world\n")
        return (root,), {}
    rng, k = np.random.RandomState(seed), 0
    _txt(root / "docs" / "all.map", '00 "the dog"\n01 "red and blue"\n02 "tell me a story"\n')
    verified = {"00": [], "01": []}
    for g, spk in enumerate(("ks001", "ks101", "ks201", "ks401")):
        cat = str(g)
        for prompt in ("00", "01"):
            k += 1
            utt = f"{spk}{prompt}0"
            _wav(root / "speech" / "scripted" / prompt / cat / spk / f"{utt}.wav", _seconds(rng),
                 seed + k)
            if not (prompt == "01" and g == 3):
                verified[prompt].append(f"speech/scripted/{prompt}/{cat}/{spk}/{utt}.wav "
                                        f"{1 + k % 4}")
        k += 1
        utt = f"{spk}xx0"
        _wav(root / "speech" / "spontaneous" / "02" / cat / spk / f"{utt}.wav",
             _seconds(rng, 2.0, 4.0), seed + k)
        _txt(root / "trans" / "spontaneous" / "02" / cat / spk / f"{utt}.txt",
             f"<bn> {_words(rng, ENGLISH)} <ln>\n{_words(rng, ENGLISH)} <sil>\n")
    for prompt, lines in verified.items():
        _txt(root / "docs" / f"{prompt}-verified.txt", "\n".join(lines) + "\n")
    return (root,), {}


def adept_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche2.py:528 (one emphasis prompt);
    ``wide``: the types ``emphasis`` and ``propositional_attitude``, 2 labels
    and 2 prompts each at 44.1 kHz; ``adept_prompts.json`` interprets the
    emphasis prompts only."""
    if layout == "jaxtest":
        _wav(root / "wav_44khz" / "emphasis" / "marked" / "prompt_1.wav", sr=44100, seed=92)
        _txt(root / "txt" / "emphasis" / "marked" / "prompt_1.txt",
             "I never said she stole my money.")
        _txt(root / "adept_prompts.json",
             json.dumps({"emphasis": {"prompt_1": {"marked": "stress on never"}}}))
        return (root,), {}
    rng, k, interpretations = np.random.RandomState(seed), 0, {"emphasis": {}}
    for kind, labels in (("emphasis", ("marked", "unmarked")),
                         ("propositional_attitude", ("surprise", "incredulity"))):
        for label in labels:
            for prompt in ("01_a", "02_b"):
                k += 1
                _wav(root / "wav_44khz" / kind / label / f"{prompt}.wav", _seconds(rng),
                     seed + k, sr=44100)
                _txt(root / "txt" / kind / label / f"{prompt}.txt", _words(rng, ENGLISH) + "\n")
                if kind == "emphasis":
                    interpretations["emphasis"].setdefault(prompt, {})[label] = (
                        f"stress on {_words(rng, ENGLISH, 1, 2)}")
    _txt(root / "adept_prompts.json", json.dumps(interpretations))
    return (root,), {}


def grid_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche3.py:423 (one 3 s video of s1,
    written as the JAX test writes it: a RIFF payload under the ``.mpg``
    name); ``wide``: speakers s1 and s2 with 3 such videos of 1-3 s each
    (one of s2 without an ``.align`` file), alignments in 1/1000 s with
    ``sil`` at both ends, and an empty ``audio_25k/``."""
    (root / "audio_25k").mkdir(parents=True, exist_ok=True)
    if layout == "jaxtest":
        _wav(root / "video" / "s1" / "bbaf2n.mpg", 3.0, 36)
        _txt(root / "alignments" / "s1" / "bbaf2n.align",
             "0 500 sil\n500 1500 bin\n1500 2500 blue\n2500 3000 sil\n")
        return (root,), {}
    rng, k = np.random.RandomState(seed), 0
    for spk in ("s1", "s2"):
        for vid in ("bbaf2n", "lgaz8p", "swwp2s"):
            k += 1
            seconds = _seconds(rng)
            _wav(root / "video" / spk / f"{vid}.mpg", seconds, seed + k)
            if spk == "s2" and vid == "swwp2s":
                continue
            edges = np.linspace(0, int(seconds * 1000), 6).astype(int)
            words = ["sil"] + [ENGLISH[i] for i in rng.randint(0, len(ENGLISH), 3)] + ["sil"]
            _txt(root / "alignments" / spk / f"{vid}.align",
                 "".join(f"{a} {b} {w}\n" for a, b, w in zip(edges[:-1], edges[1:], words)))
    return (root,), {}


def oto_speech_tree(root, layout="wide", seed=0):
    """``jaxtest``: tests/test_recipes_tranche4.py:283 (one 2 s 48 kHz FLAC
    session in one shard, a segment with word alignments and one of a
    missing session); ``wide``: parts ``train`` and ``dev``, each of 2 tar
    shards of 2 FLAC sessions of 3-5 s at 48 kHz (nested paths inside the
    tars), and a ``seglst.json`` with 2 segments per session (word
    alignments on most), a segment of a missing session and a zero-length
    one."""
    if layout == "jaxtest":
        corpus = root / "corpus"
        flac_src = root / "stage" / "sessA.flac"
        _flac(flac_src, seconds=2.0, sr=48000, seed=17)
        part_dir = corpus / "data" / "train"
        part_dir.mkdir(parents=True)
        with tarfile.open(part_dir / "shard0.tar", "w") as tar:
            tar.add(flac_src, arcname="inner/sessA.flac")
        _txt(corpus / "seglst.json", json.dumps([
            {"session_id": "sessA", "start_time": 0.2, "end_time": 1.4, "words": "hello oto",
             "speaker": "spk0", "word_alignment": [["hello", 0.2, 0.7], ["oto", 0.8, 1.4]]},
            {"session_id": "missing", "start_time": 0.0, "end_time": 1.0, "words": "x",
             "speaker": "y"}]))
        return (corpus,), {}
    rng, corpus, labels, k = np.random.RandomState(seed), root / "corpus", [], 0
    for part in ("train", "dev"):
        part_dir = corpus / "data" / part
        part_dir.mkdir(parents=True)
        for shard in range(2):
            with tarfile.open(part_dir / f"shard{shard}.tar", "w") as tar:
                for s in range(2):
                    k += 1
                    session = f"{part}_sess{shard}{s}"
                    seconds = _seconds(rng, 3.0, 5.0)
                    src = _flac(root / "stage" / f"{session}.flac", seconds, seed + k, sr=48000)
                    tar.add(src, arcname=f"{part}/{shard:05d}/{session}.flac")
                    for a, b in ((0.1, 1.3), (1.5, seconds - 0.2)):
                        words = [ENGLISH[i] for i in rng.randint(0, len(ENGLISH), 3)]
                        seg = {"session_id": session, "start_time": a, "end_time": b,
                               "words": " ".join(words), "speaker": f"spk{s}"}
                        if k % 4:
                            edges = np.round(np.linspace(a, b, 4), 4)
                            seg["word_alignment"] = [[w, float(x), float(y)] for w, x, y in
                                                     zip(words, edges[:-1], edges[1:])]
                        labels.append(seg)
    labels.insert(3, {"session_id": "not_on_disk", "start_time": 0.0, "end_time": 1.0,
                      "words": "gone", "speaker": "spk9"})
    labels.append({"session_id": "train_sess00", "start_time": 2.0, "end_time": 2.0,
                   "words": "", "speaker": "spk0"})
    _txt(corpus / "seglst.json", json.dumps(labels))
    return (corpus,), {}


# -- each recipe against JAX -----------------------------------------------------------------

RECIPES = ("hifitts", "ears", "daily_talk", "cmu_arctic", "cmu_indic", "l2_arctic", "cmu_kids",
           "cslu_kids", "adept", "grid", "oto_speech")
MODULES = {
    "hifitts": (phifitts, jhifitts), "ears": (pears, jears), "daily_talk": (pdaily, jdaily),
    "cmu_arctic": (parctic, jarctic), "cmu_indic": (pindic, jindic),
    "l2_arctic": (pl2, jl2), "cmu_kids": (pkids, jkids), "cslu_kids": (pcslu, jcslu),
    "adept": (padept, jadept), "grid": (pgrid, jgrid), "oto_speech": (poto, joto)}
TREES = {
    "hifitts": hifitts_tree, "ears": ears_tree, "daily_talk": daily_talk_tree,
    "cmu_arctic": cmu_arctic_tree, "cmu_indic": cmu_indic_tree, "l2_arctic": l2_arctic_tree,
    "cmu_kids": cmu_kids_tree, "cslu_kids": cslu_kids_tree, "adept": adept_tree,
    "grid": grid_tree, "oto_speech": oto_speech_tree}
CASES = {f"{r}-{layout}": (r, layout, {}) for r in RECIPES for layout in ("jaxtest", "wide")}
CASES.update({
    "hifitts-wide-2jobs": ("hifitts", "wide", {"num_jobs": 2}),
    "cmu_kids-wide-relative": ("cmu_kids", "wide", {"absolute_paths": False}),
    "cslu_kids-wide-raw-text": ("cslu_kids", "wide", {"normalize_text": False}),
    "cslu_kids-wide-relative": ("cslu_kids", "wide", {"absolute_paths": False}),
    "grid-wide-no-supervisions": ("grid", "wide", {"with_supervisions": False}),
    "grid-wide-2jobs": ("grid", "wide", {"num_jobs": 2}),
    "oto_speech-wide-two-parts": ("oto_speech", "wide", {"parts": ("train", "dev")}),
    "oto_speech-wide-8k": ("oto_speech", "wide", {"parts": ("dev",), "target_sr": 8000}),
})


def _prepare(pkg, recipe, args, kwargs, out):
    """One package's ``prepare_*`` after its own ``fix_random_seed(0)``."""
    (fix_random_seed if pkg == "port" else jfix)(0)
    module = MODULES[recipe][pkg == "jax"]
    return getattr(module, f"prepare_{recipe}")(*args, output_dir=out, **kwargs)


def _by_id(manifests):
    """``_dicts`` with every manifest's items in id order (GRID: JAX takes
    the videos as they complete)."""
    if isinstance(manifests, dict):
        return {k: _by_id(v) for k, v in manifests.items()}
    return sorted(_dicts(manifests), key=lambda d: d["id"])


def _count(made) -> int:
    if isinstance(made, (dict, tuple)):
        values = made.values() if isinstance(made, dict) else made
        return sum(_count(v) for v in values)
    return len(list(made))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_equals_jax(tmp_path, case):
    """The returned manifests (paths included) and every file that each
    package's ``prepare_*`` writes on the same layout are equal; JAX runs
    second, so otoSpeech's JAX run reuses the shards the port unpacked."""
    recipe, layout, extra = CASES[case]
    args, kwargs = TREES[recipe](tmp_path / "corpus", layout)
    kwargs = {**kwargs, **extra}
    ours = _prepare("port", recipe, args, kwargs, tmp_path / "ours")
    theirs = _prepare("jax", recipe, args, kwargs, tmp_path / "jax")
    if recipe == "grid":
        assert _by_id(ours) == _by_id(theirs)
    else:
        assert _dicts(ours) == _dicts(theirs)
    keyed = recipe == "grid"
    written = _files(tmp_path / "ours", keyed=keyed)
    assert written and written == _files(tmp_path / "jax", keyed=keyed)
    assert _count(ours) > 0


# -- what the JAX tests expect, and what the wide layouts hold -----------------------------


def _prep(recipe, tmp_path, layout="wide", **kwargs):
    args, tree_kwargs = TREES[recipe](tmp_path / "corpus", layout)
    return _prepare("port", recipe, args, {**tree_kwargs, **kwargs}, tmp_path / "out"), args


def test_hifitts_partitions_and_cached_rerun(tmp_path):
    """One partition per (speaker, quality, split); a re-run reads every
    written partition back and prepares only the one whose files were
    removed, in both packages."""
    m, args = _prep("hifitts", tmp_path)
    assert sorted(m) == sorted(f"{s}_{q}_{p}" for s, q in (("92", "clean"), ("6670", "clean"),
                                                           ("6097", "other"))
                               for p in ("train", "dev", "test"))
    sup = list(m["6097_other_dev"]["supervisions"])[0]
    assert sup.speaker == "Phil Benson" and sup.gender == "M"
    assert sup.custom["split"] == "other" and sup.custom["text_punct"].endswith(".")
    assert all(r.sampling_rate == 44100 for p in m.values() for r in p["recordings"])
    jax_out = tmp_path / "jax"
    jhifitts.prepare_hifitts(*args, output_dir=jax_out)
    for out in (tmp_path / "out", jax_out):
        for kind in ("recordings", "supervisions"):
            (out / f"hifitts_{kind}_92_clean_dev.jsonl.gz").unlink()
    again = phifitts.prepare_hifitts(*args, output_dir=tmp_path / "out")
    jagain = jhifitts.prepare_hifitts(*args, output_dir=jax_out)
    assert _dicts(again) == _dicts(m) == _dicts(jagain)
    assert _files(tmp_path / "out") == _files(jax_out)


def test_hifitts_as_the_jax_test_expects(tmp_path):
    m, args = _prep("hifitts", tmp_path, "jaxtest")
    (sup,) = list(m["92_clean_train"]["supervisions"])
    assert sup.text == "hello world" and sup.custom["text_punct"] == "Hello, world!"
    again = phifitts.prepare_hifitts(*args, output_dir=tmp_path / "out")
    assert len(list(again["92_clean_train"]["recordings"])) == 1


def test_ears_untranscribed_utterance_and_cached_rerun(tmp_path):
    """A free-speech utterance keeps ``text=None``; the missing speakers are
    skipped; a re-run reads the written pair back without reading the
    corpus (its speaker metadata removed here), in both packages."""
    m, args = _prep("ears", tmp_path)
    sups = {s.id: s for s in m["supervisions"]}
    assert sorted({s.speaker for s in sups.values()}) == ["p001", "p002", "p005"]
    assert [s.id for s in sups.values() if s.text is None] == [
        f"{spk}_freeform_speech_01" for spk in ("p001", "p002", "p005")]
    p002 = sups["p002_read_fast"]
    assert p002.gender == "male" and "gender" not in p002.custom
    assert p002.custom["native language"] == "american english"
    jm = jears.prepare_ears(*args, output_dir=tmp_path / "jax")
    (args[0] / "speaker_statistics.json").unlink()
    again = pears.prepare_ears(*args, output_dir=tmp_path / "out")
    jagain = jears.prepare_ears(*args, output_dir=tmp_path / "jax")
    assert _dicts(again) == _dicts(m) == _dicts(jagain) == _dicts(jm)
    with pytest.raises(FileNotFoundError):
        pears.prepare_ears(*args, output_dir=tmp_path / "fresh")
    with pytest.raises(FileNotFoundError):
        jears.prepare_ears(*args, output_dir=tmp_path / "jfresh")


def test_daily_talk_returns_a_tuple(tmp_path):
    (recordings, supervisions), _ = _prep("daily_talk", tmp_path)
    assert len(recordings) == len(supervisions) == 9
    sup = sorted(supervisions, key=lambda s: s.id)[4]
    assert sup.id == "dailytalk_4" and sup.recording_id == "dailytalk_1_1_d1"
    assert sup.speaker == "dailytalk_spk1" and sup.gender == "F"
    assert sup.custom == {"turn": 1, "topic": "work", "emotion": "happiness",
                          "act": "question"}
    assert {r.sampling_rate for r in recordings} == {44100}


@pytest.mark.parametrize("index", [2, -1])
def test_daily_talk_unknown_speaker_raises_as_jax(tmp_path, index):
    args, _ = daily_talk_tree(tmp_path / "corpus", speaker_index=index)
    for prepare in (pdaily.prepare_daily_talk, jdaily.prepare_daily_talk):
        with pytest.raises(AssertionError, match="Unknown speaker index"):
            prepare(*args)


def test_cmu_arctic_drops_an_unrecorded_prompt_where_jax_raises(tmp_path):
    """A prompt of ``txt.done.data`` without a recording: the port drops it
    (ROADMAP C2), the JAX recipe looks its recording up and raises
    ``KeyError``. The rest equals JAX's result on the layout without it."""
    m, args = _prep("cmu_arctic", tmp_path, "unrecorded")
    with pytest.raises(KeyError, match="aew-arctic_b0540"):
        jarctic.prepare_cmu_arctic(*args)
    wide, _ = cmu_arctic_tree(tmp_path / "wide")

    def rooted(made, root):
        return json.loads(json.dumps(_dicts(made)).replace(str(root), "<root>"))

    assert rooted(m, args[0]) == rooted(parctic.prepare_cmu_arctic(*wide), wide[0]) == rooted(
        jarctic.prepare_cmu_arctic(*wide), wide[0])
    sups = {s.id: s for s in m["supervisions"]}
    assert len(sups) == len(m["recordings"]) == 8 and "aew-arctic_b0540" not in sups
    assert sups["bdl-arctic_a0001"].gender == "male"
    assert sups["bdl-arctic_a0001"].custom == {"accent": "US Midwest"}
    assert sups["aew-arctic_a0001"].gender is None
    assert sups["aew-arctic_a0001"].custom == {"accent": None}
    assert all('"' not in s.text for s in sups.values())


def test_cmu_indic_scripts_and_trailing_whitespace(tmp_path):
    """Each prompt in its own script, the arctic prompts English with the
    language as accent, ``custom`` None where empty; a line ending in three
    spaces keeps, in both packages, its closing ``" )`` minus two
    characters: the text ends in the characters the ``[2:-2]`` cut leaves."""
    m, args = _prep("cmu_indic", tmp_path)
    jm = jindic.prepare_cmu_indic(*args)
    sups, jsups = ({s.id: s for s in x["supervisions"]} for x in (m, jm))
    ben, tel = sups["ben_rm-ben_0001"], sups["tel_ss-tel_0001"]
    assert ben.language == "Bengali" and ben.custom == {"age": 29} and ben.gender == "F"
    assert all(ch in "".join(BENGALI) + " " for ch in ben.text)
    assert tel.language == "Telugu" and tel.custom is None
    assert all(ch in "".join(TELUGU) + " " for ch in tel.text)
    eng = sups["tel_ss-arctic_a0002"]
    assert eng.language == "English" and eng.custom == {"accent": "Telugu"}
    odd, jodd = sups["tel_ss-tel_0002"], jsups["tel_ss-tel_0002"]
    assert odd.text == jodd.text and odd.text.endswith(" ) ")
    assert all(s.text == jsups[i].text for i, s in sups.items())


def test_l2_arctic_read_and_suitcase(tmp_path):
    m, _ = _prep("l2_arctic", tmp_path)
    read, suitcase = m["read"], m["suitcase"]
    assert len(read["recordings"]) == len(read["supervisions"]) == 12
    assert sorted(s.id for s in suitcase["supervisions"]) == [
        "suitcase_corpus-aba", "suitcase_corpus-hjk"]
    by_id = {s.id: s for s in read["supervisions"]}
    assert by_id["ykwk-arctic_b0003"].custom == {"accent": "Korean"}
    assert by_id["bwc-arctic_a0001"].gender == "M" and by_id["hjk-arctic_a0002"].gender == "F"
    assert {r.sampling_rate for r in read["recordings"]} == {44100}


def test_l2_arctic_stray_txt_raises_as_jax(tmp_path):
    """A ``.txt`` outside a speaker's ``transcript/`` (a README) is read as a
    transcript of the speaker named by its grandparent directory: both
    packages raise ``KeyError``."""
    args, _ = l2_arctic_tree(tmp_path / "corpus")
    _txt(args[0] / "README.txt", "L2-ARCTIC v5.0\n")
    for prepare in (pl2.prepare_l2_arctic, jl2.prepare_l2_arctic):
        with pytest.raises(KeyError):
            prepare(*args)


def test_cmu_kids_fields(tmp_path):
    """Every prompt, spoken transcript, bin, grade and age as written (``NA``
    as None); the SPHERE samples equal the int16 written / 32768."""
    m, args = _prep("cmu_kids", tmp_path)
    rel, _ = _prep("cmu_kids", tmp_path / "rel", absolute_paths=False)
    sentences = dict(line.split("\t")[::2] for line in
                     (args[0] / "tables" / "sentence.tbl").read_text().splitlines())
    spoken = dict(line.split(" ", 1) for line in
                  (args[0] / "tables" / "transcrp.tbl").read_text().splitlines())
    grades = {"fabc": ("3", 9), "mdef": (None, None), "fghi": ("K", None), "mjkl": (None, 7)}
    sups = list(m["supervisions"])
    assert len(sups) == 16 and {s.custom["bin"] for s in sups} == {1, 2}
    for s in sups:
        assert s.text == sentences[s.id[4:7]] and s.custom["spoken_transcript"] == spoken[s.id]
        assert (s.custom["speaker_grade"], s.custom["speaker_age"]) == grades[s.speaker]
        assert s.gender == ("Male" if s.speaker[0] == "m" else "Female")
    for rec, rrec in zip(m["recordings"], rel["recordings"]):
        assert rec.sources[0].source.startswith(str(args[0]))
        assert rrec.sources[0].source == f"{rec.id[:4]}/signal/{rec.id}.sph"
        x = rec.load_audio()
        assert x.dtype == np.float32 and x.shape == (1, rec.num_samples)
    first = list(m["recordings"])[0]
    written = np.clip(np.round(_sig(first.duration, 1).astype(np.float64) * 32768.0),
                      -32768, 32767).astype(np.int16)
    assert np.array_equal(first.load_audio()[0], written.astype(np.float32)[0] / 32768.0)


def test_cmu_kids_as_the_jax_test_expects(tmp_path):
    m, _ = _prep("cmu_kids", tmp_path, "jaxtest")
    (sup,) = list(m["supervisions"])
    assert sup.text == "The dog ran away."
    assert sup.gender == "Female" and sup.speaker == "fabc"
    assert sup.custom["bin"] == 1 and sup.custom["speaker_age"] == 9


def test_cslu_kids_texts_and_labels(tmp_path):
    m, args = _prep("cslu_kids", tmp_path)
    raw, _ = _prep("cslu_kids", tmp_path / "raw", normalize_text=False)
    sups, raws = ({s.id: s for s in x["supervisions"]} for x in (m, raw))
    assert sups["ks001000"].text == "the dog" and sups["ks101010"].text == "red and blue"
    assert sups["ks401010"].custom == {"type": "scripted", "verification_label": None}
    assert all(1 <= s.custom["verification_label"] <= 4 for i, s in sups.items()
               if s.custom["type"] == "scripted" and i != "ks401010")
    story = sups["ks201xx0"]
    assert story.custom == {"type": "spontaneous"} and "<" not in story.text
    assert raws["ks201xx0"].text.startswith("<bn> ") and "<sil>" in raws["ks201xx0"].text


def test_cslu_kids_file_names_split_the_cache_as_in_jax(tmp_path):
    """The recordings are written under ``cslu-kids_`` and the supervisions
    under ``cslu_kids_`` (JAX's names, kept; ROADMAP C2): the cache reader finds one
    half under either prefix in both packages, so a user reads each file
    by its name."""
    _, args = _prep("cslu_kids", tmp_path)
    jcslu.prepare_cslu_kids(*args, output_dir=tmp_path / "jax")
    for out, read in ((tmp_path / "out", read_manifests_if_cached),
                      (tmp_path / "jax", jread_cached)):
        assert sorted(p.name for p in out.iterdir()) == [
            "cslu-kids_recordings_all.jsonl.gz", "cslu_kids_supervisions_all.jsonl.gz"]
        assert {k: sorted(v) for k, v in read(["all"], out, prefix="cslu_kids").items()} == {
            "all": ["supervisions"]}
        assert {k: sorted(v) for k, v in read(["all"], out, prefix="cslu-kids").items()} == {
            "all": ["recordings"]}


def test_adept_interpretations(tmp_path):
    m, _ = _prep("adept", tmp_path)
    sups = {s.id: s for s in m["supervisions"]}
    assert len(sups) == len(m["recordings"]) == 8
    marked = sups["emphasis_marked_01_a"]
    assert marked.custom["text"].startswith("stress on ") and marked.speaker == "ADEPT_01"
    surprise = sups["propositional_attitude_surprise_02_b"]
    assert surprise.custom == {"type": "propositional_attitude", "label": "surprise",
                               "prompt_id": "02_b"}


def test_grid_alignments_and_order(tmp_path):
    """Times / 1000, ``sil`` out of the text; a video without alignments
    loses its recording to ``fix_manifests`` unless supervisions are off;
    the port's order is the order the videos were found, at one job and at
    two."""
    m, args = _prep("grid", tmp_path)
    found = [f"{p.parent.name}_{p.stem}" for p in args[0].rglob("*.mpg")]
    two = pgrid.prepare_grid(*args, num_jobs=2)
    assert [r.id for r in m["recordings"]] == [r.id for r in two["recordings"]] == [
        i for i in found if i != "s2_swwp2s"]
    assert [s.id for s in m["supervisions"]] == [r.id for r in m["recordings"]]
    for s in m["supervisions"]:
        words = s.alignment["word"]
        assert words[0].symbol == words[-1].symbol == "sil" and len(words) == 5
        assert s.text == " ".join(w.symbol for w in words[1:-1])
        assert abs(words[-1].end - s.duration) < 2e-3
    only = pgrid.prepare_grid(*args, with_supervisions=False)
    assert set(only) == {"recordings"} and [r.id for r in only["recordings"]] == found


def test_grid_skips_a_video_whose_alignment_is_malformed(tmp_path):
    """An ``.align`` line without its word makes ``process_single`` raise; both
    packages skip that video, recording and all."""
    args, _ = grid_tree(tmp_path / "corpus")
    _txt(args[0] / "alignments" / "s1" / "lgaz8p.align", "0 500 sil\n500 1500\n")
    ours = pgrid.prepare_grid(*args, output_dir=tmp_path / "ours")
    theirs = jgrid.prepare_grid(*args, output_dir=tmp_path / "jax")
    assert "s1_lgaz8p" not in {r.id for r in ours["recordings"]}
    assert _by_id(ours) == _by_id(theirs) and len(ours["recordings"]) == 4


def test_grid_as_the_jax_test_expects(tmp_path):
    m, _ = _prep("grid", tmp_path, "jaxtest")
    (sup,) = list(m["supervisions"])
    assert sup.text == "bin blue" and sup.speaker == "s1"
    items = sup.alignment["word"]
    assert len(items) == 4 and items[1].symbol == "bin"
    assert items[1].start == 0.5 and items[1].duration == 1.0


def test_oto_speech_parts_segments_and_reused_shards(tmp_path):
    """Two parts; segments of sessions not on disk and of zero length
    skipped; alignments relative to the segment; a second run (the port
    after JAX) reuses the unpacked shards, whose ``.done`` markers stand."""
    (corpus,), _ = oto_speech_tree(tmp_path / "corpus")
    m = joto.prepare_oto_speech(corpus, tmp_path / "jax", parts=("train", "dev"))
    markers = sorted(p.name for p in corpus.rglob("*.done"))
    assert markers == sorted(["shard0.tar.done", "shard1.tar.done"] * 2)
    mtimes = {p: p.stat().st_mtime_ns for p in corpus.rglob("unpacked/*.flac")}
    ours = poto.prepare_oto_speech(corpus, tmp_path / "out", parts=("train", "dev"))
    assert {p: p.stat().st_mtime_ns for p in corpus.rglob("unpacked/*.flac")} == mtimes
    assert _dicts(ours) == _dicts(m)
    for part in ("train", "dev"):
        recs, sups = ours[part]["recordings"], list(ours[part]["supervisions"])
        assert len(recs) == 4 and len(sups) == 8
        assert {r.sampling_rate for r in recs} == {16000}
        assert all(s.recording_id.startswith(part) for s in sups)
    sup = next(s for s in ours["train"]["supervisions"] if s.alignment)
    assert sup.alignment["word"][0].start == 0.0
    assert abs(sum(w.duration for w in sup.alignment["word"]) - sup.duration) < 1e-3


def test_oto_speech_needs_its_labels(tmp_path):
    (corpus,), _ = oto_speech_tree(tmp_path / "corpus", "jaxtest")
    (corpus / "seglst.json").unlink()
    for prepare in (poto.prepare_oto_speech, joto.prepare_oto_speech):
        with pytest.raises(FileNotFoundError):
            prepare(corpus, tmp_path / "out")


def test_downloads_are_left_out():
    """The port defines none of the JAX modules' downloads, and its modules
    use no network library."""
    for recipe, (port, jax_module) in MODULES.items():
        name = f"download_{recipe}"
        # L2-ARCTIC and the two LDC corpora have no download in JAX either.
        assert hasattr(jax_module, name) == (recipe not in ("l2_arctic", "cmu_kids",
                                                            "cslu_kids")), name
        assert not hasattr(port, name), name
        source = open(port.__file__).read()
        for word in ("urllib", "requests", "resumable_download", "import gdown",
                     "snapshot_download", "subprocess", "zenodo_get "):
            assert word not in source, (recipe, word)


# -- the prepare commands --------------------------------------------------------------------

COMMANDS = {
    # command: (argv after the corpus, the layout maker, the function's keyword arguments)
    "hifitts": (["-j", "2"], hifitts_tree, {"num_jobs": 2}),
    "ears": (["-j", "1"], ears_tree, {}),
    "daily-talk": (["-j", "1"], daily_talk_tree, {}),
    "cmu-arctic": ([], cmu_arctic_tree, {}),
    "cmu-indic": ([], cmu_indic_tree, {}),
    "l2-arctic": ([], l2_arctic_tree, {}),
    "cmu-kids": (["--absolute-paths", "false"], cmu_kids_tree, {"absolute_paths": False}),
    "cmu-kids-default": ([], cmu_kids_tree, {}),
    "cslu-kids": (["--no-normalize-text"], cslu_kids_tree, {"normalize_text": False}),
    "cslu-kids-relative": (["--absolute-paths", "false", "--normalize-text"], cslu_kids_tree,
                           {"absolute_paths": False}),
    "adept": ([], adept_tree, {}),
    "grid": (["--no-supervisions", "--jobs", "2"], grid_tree,
             {"with_supervisions": False, "num_jobs": 2}),
    "grid-default": ([], grid_tree, {}),
    "oto-speech": (["-p", "train", "-p", "dev", "--target-sr", "8000"], oto_speech_tree,
                   {"parts": ("train", "dev"), "target_sr": 8000}),
}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_prepare_command_writes_what_its_function_writes(tmp_path, name):
    """Each ``prepare`` command writes the files its function writes, and
    the JAX CLI's command the same, with the output directory replaced."""
    from test_torch_cli import _both as both_clis

    options, build, kwargs = COMMANDS[name]
    command = name.replace("-default", "").replace("-relative", "")
    recipe = command.replace("-", "_")
    args, _ = build(tmp_path / "corpus")
    runs = both_clis(tmp_path, "prepare", command, *args, "{out}", *options)
    _prepare("port", recipe, args, kwargs, tmp_path / "function")
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    keyed = recipe == "grid"
    ours = _files(pout, keyed=keyed)
    assert ours and ours == _files(tmp_path / "function", keyed=keyed) == _files(jout, keyed=keyed)


# -- the slice: CMU Kids into the on-device chain --------------------------------------------


@pytest.fixture(scope="module")
def kids_slice(tmp_path_factory):
    root = tmp_path_factory.mktemp("kids_slice")
    args, kwargs = cmu_kids_tree(root / "corpus")
    made = {}
    for pkg, CS in (("port", CutSet), ("jax", J.CutSet)):
        m = _prepare(pkg, "cmu_kids", args, kwargs, root / pkg)
        made[pkg] = CS.from_manifests(recordings=m["recordings"],
                                      supervisions=m["supervisions"]).to_eager()
    return root, list(made["port"]), list(made["jax"])


def test_cmu_kids_utterances_through_the_augmenter_equal_jax(kids_slice):
    """The first 12 CMU Kids utterances (1-3 s SPHERE), in batches of the
    3 s x 4 bucket through each package's augmenter with the same MUSAN
    noise pool and real RIR, speed 1.1, SNR (10, 20) and SpecAugment: the
    port within ``AUG_TOL`` of the JAX augmenter whose fbank stage is its
    kernel route in float64."""
    root, ours, theirs = kids_slice
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
