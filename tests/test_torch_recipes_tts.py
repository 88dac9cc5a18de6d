"""
The port's TTS recipes (lhotse_tpu_torch.recipes ``libritts``, ``ljspeech``
and ``vctk``) against the JAX package's, on the fixture layouts of
tests/test_recipes.py, tests/test_recipes_tranche6.py and
tests/test_recipes_tranche9.py (made from a numpy seed) and on VCTK 0.92's
FLAC layout, and the slice as a whole at a small size: a LibriTTS layout
through each package's ``prepare_libritts`` → ``CutSet.from_manifests`` →
``resample(16000)`` → ``SpeechSynthesisDataset`` with ``OnTheFlyFeatures``
and a ``TokenCollater``: the same audio, text and tokens, and features
within ``EXTRACTOR_TOL`` (tests/test_torch_recipes.py) of the JAX chain
with its extractor's device route.

Written ``.jsonl.gz`` manifests are compared after decompression, since a
gzip header carries its write time.
"""
import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.dataset.collation import TokenCollater as JTokenCollater
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.speech_synthesis import SpeechSynthesisDataset as JSynthesis
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import libritts as jlibritts
from lhotse_tpu.recipes import ljspeech as jljspeech
from lhotse_tpu.recipes import vctk as jvctk
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.collation import TokenCollater
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_synthesis import SpeechSynthesisDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import libritts as plibritts
from lhotse_tpu_torch.recipes import ljspeech as pljspeech
from lhotse_tpu_torch.recipes import vctk as pvctk
from test_torch_recipes_asr import _both, _dicts, _noise, _wav
from test_torch_recipes_noise import EXTRACTOR_TOL


def libritts_tree(root, layout="recipes", n_chapters=1):
    """``recipes``: tests/test_recipes.py:75 (a chapter of two 1 s
    utterances, ``SPEAKERS.txt``), 24 kHz WAV; ``slice``: ``n_chapters``
    chapters of four 0.6-1.4 s tone bursts each in ``dev-clean``, a
    ``test-clean`` chapter without a book file, a macOS resource fork and
    the corpus's known-bad file (both skipped)."""
    if layout == "recipes":
        chapter = root / "dev-clean" / "84" / "121123"
        _wav(chapter / "84_121123_000007_000001.wav", sr=24000, seed=7)
        _wav(chapter / "84_121123_000008_000000.wav", sr=24000, seed=8)
        (chapter / "84_121123.trans.tsv").write_text(
            "84_121123_000007_000001\tMaximilian!\tMaximilian.\n"
            "84_121123_000008_000000\tVillefort rose.\tVillefort rose.\n")
        (chapter / "84_121123.book.tsv").write_text(
            "84_121123_000007_000001 x x 12.5\n84_121123_000008_000000 x x 7.25\n")
        (root / "SPEAKERS.txt").write_text(";ID |SEX| SUBSET\n84 | F | dev-clean\n")
        return root
    rng = np.random.RandomState(24)
    speakers = [";ID |SEX| SUBSET |MINUTES| NAME"]
    for c in range(n_chapters + 1):
        part, spk, chap = ("dev-clean", str(84 + c), str(121123 + c)) if c < n_chapters else (
            "test-clean", "1089", "134686")
        chapter = root / part / spk / chap
        chapter.mkdir(parents=True)
        trans, book = [], []
        for u in range(4):
            utt = f"{spk}_{chap}_{u:06d}_000000"
            n = int(rng.uniform(0.6, 1.4) * 24000)
            x = 0.2 * np.sin(2 * np.pi * (140 + 15 * u + 40 * c) * np.arange(n) / 24000)
            write_wav(chapter / f"{utt}.wav", (x + 0.01 * rng.randn(n))[None].astype(np.float32),
                      24000)
            trans.append(f"{utt}\tSay {u}, \"Dr. {spk}\"!\tSay {u}, Doctor {spk}.")
            book.append(f"{utt} the book {u} {10 + u + 0.25 * c}")
        (chapter / f"{spk}_{chap}.trans.tsv").write_text("\n".join(trans) + "\n")
        if part == "dev-clean":
            (chapter / f"{spk}_{chap}.book.tsv").write_text("\n".join(book) + "\n")
        speakers.append(f"{spk} | {'MF'[c % 2]} | {part} | 25.0 | Reader {c}")
    _wav(root / "dev-clean" / "84" / "121123" / "._84_121123_000000_000000.wav", sr=24000)
    _wav(root / "dev-clean" / "1092" / "134562" / "1092_134562_000013_000004.wav", sr=24000)
    (root / "SPEAKERS.txt").write_text("\n".join(speakers) + "\n")
    return root


def ljspeech_tree(root, layout="recipes"):
    """``recipes``: tests/test_recipes.py:340 (a row without audio);
    ``tranche9``: tests/test_recipes_tranche9.py:19 (two clips, a ghost
    row); 22,050 Hz WAV."""
    (root / "wavs").mkdir(parents=True)
    if layout == "recipes":
        _wav(root / "wavs" / "LJ001-0001.wav", sr=22050, seed=50)
        rows = ["LJ001-0001|Printing, in the only sense|printing in the only sense",
                "LJ001-0002|missing audio|missing audio"]
    else:
        rows = []
        for i in range(2):
            _wav(root / "wavs" / f"LJ001-000{i}.wav", seconds=0.5, sr=22050, seed=i)
            rows.append(f"LJ001-000{i}|Printing, in the year 1476|printing, in the year fourteen "
                        "seventy-six")
        rows.append("LJ999-9999|Ghost row|ghost row")
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    return root


def vctk_tree(root, layout="recipes"):
    """``recipes``: tests/test_recipes.py:360 (one speaker); ``tranche6``:
    tests/test_recipes_tranche6.py:93 (two speakers, a transcript without
    audio); ``0.92``: Edinburgh's distribution, 48 kHz FLAC per
    microphone under ``wav48_silence_trimmed``, speaker ids with their
    ``p``, p280 without ``mic2`` and a p362 transcript without audio."""
    root.mkdir(parents=True)
    if layout == "recipes":
        (root / "speaker-info.txt").write_text(
            "ID  AGE  GENDER  ACCENTS  REGION\n225  23  F  English  Southern England\n")
        (root / "txt" / "p225").mkdir(parents=True)
        (root / "txt" / "p225" / "p225_001.txt").write_text("Please call Stella.\n")
        _wav(root / "wav48" / "p225" / "p225_001.wav", sr=48000, seed=51)
        return root
    if layout == "tranche6":
        for spk, utt, text in (("p225", "p225_001", "Please call Stella."),
                               ("p225", "p225_002", "Ask her to bring these things."),
                               ("p226", "p226_001", "Please call Stella.")):
            _wav(root / "wav48" / spk / f"{utt}.wav", sr=48000)
            (root / "txt" / spk).mkdir(parents=True, exist_ok=True)
            (root / "txt" / spk / f"{utt}.txt").write_text(text + "\n")
        (root / "txt" / "p226" / "p226_999.txt").write_text("Ghost utterance.\n")
        (root / "speaker-info.txt").write_text(
            "ID  AGE  GENDER  ACCENTS  REGION\n"
            "225  23  F    English    Southern  England\n"
            "226  22  M    English    Surrey\n")
        return root
    info = ["ID  AGE  GENDER  ACCENTS  REGION  COMMENTS"]
    for k, spk in enumerate(("p225", "p280", "p362")):
        info.append(f"{spk}  {22 + k}  {'FMF'[k]}  {('English', 'French', 'American')[k]}  "
                    + ("Southern England" if k == 0 else ""))
        for u in (1, 2):
            utt = f"{spk}_{u:03d}"
            (root / "txt" / spk).mkdir(parents=True, exist_ok=True)
            (root / "txt" / spk / f"{utt}.txt").write_text(f"Please call Stella {u}.\n")
            if spk == "p362" and u == 2:
                continue
            for mic in ("mic1", "mic2"):
                if spk == "p280" and mic == "mic2":
                    continue
                path = root / "wav48_silence_trimmed" / spk / f"{utt}_{mic}.flac"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_flac(path, _noise(0.5, 10 * k + u, sr=48000), 48000)
    (root / "speaker-info.txt").write_text("\n".join(info) + "\n")
    return root


# -- the recipes against JAX ---------------------------------------------------------------


@pytest.mark.parametrize("link_previous_utt", [True, False])
@pytest.mark.parametrize("layout,parts", [
    ("recipes", "dev-clean"), ("slice", "dev-clean"), ("slice", ("dev-clean", "test-clean"))],
    ids=["recipes", "slice-dev-clean", "slice-dev+test"])
def test_prepare_libritts_equals_jax(tmp_path, layout, link_previous_utt, parts):
    root = libritts_tree(tmp_path / "LibriTTS", layout, n_chapters=2)
    ours, written = _both(tmp_path, plibritts.prepare_libritts, jlibritts.prepare_libritts, root,
                          dataset_parts=parts, link_previous_utt=link_previous_utt)
    assert len(written) == 2 * len(ours)
    sups = list(ours["dev-clean"]["supervisions"])
    assert all(s.custom["snr"] is not None for s in sups)
    assert ("prev_utt" in sups[0].custom) == link_previous_utt
    if layout == "slice":
        assert len(sups) == 8 and len(ours["dev-clean"]["recordings"]) == 8
        if parts != "dev-clean":
            assert [s.custom["snr"] for s in ours["test-clean"]["supervisions"]] == [None] * 4
    # A second run reads the cached manifests.
    again = plibritts.prepare_libritts(root, dataset_parts=parts, output_dir=tmp_path / "ours",
                                       link_previous_utt=link_previous_utt)
    assert _dicts(again) == _dicts(ours)


def test_libritts_tables_and_speakers_equal_jax(tmp_path):
    root = libritts_tree(tmp_path / "LibriTTS", "slice", n_chapters=2)
    assert plibritts.LIBRITTS == jlibritts.LIBRITTS
    assert plibritts._read_speakers(root) == jlibritts._read_speakers(root) == {
        "84": "M", "85": "F", "1089": "M"}
    assert plibritts._read_speakers(tmp_path) == {} == jlibritts._read_speakers(tmp_path)
    assert plibritts.prepare_librittsr is plibritts.prepare_libritts
    for prepare in (plibritts.prepare_libritts, jlibritts.prepare_libritts):
        with pytest.raises(AssertionError):
            prepare(root, dataset_parts="dev-noisy")
        with pytest.raises(AssertionError):
            prepare(tmp_path / "no-such-dir")


@pytest.mark.parametrize("layout", ["recipes", "tranche9"])
def test_prepare_ljspeech_equals_jax(tmp_path, layout):
    root = ljspeech_tree(tmp_path / "LJSpeech-1.1", layout)
    ours, written = _both(tmp_path, pljspeech.prepare_ljspeech, jljspeech.prepare_ljspeech, root)
    assert set(written) == {"ljspeech_recordings_all.jsonl.gz",
                            "ljspeech_supervisions_all.jsonl.gz"}
    sups = list(ours["supervisions"])
    assert len(sups) == (1 if layout == "recipes" else 2)
    theirs = list(jljspeech.prepare_ljspeech(root)["supervisions"])
    for ours_sup, their_sup in zip(sups, theirs):
        normalized = pljspeech.text_normalizer(ours_sup)
        assert normalized.to_dict() == jljspeech.text_normalizer(their_sup).to_dict()
        assert normalized.text == normalized.text.upper() and "," not in normalized.text


@pytest.mark.parametrize("layout,kwargs", [
    ("recipes", {}), ("tranche6", {}), ("0.92", dict(use_edinburgh_vctk_url=True)),
    ("0.92", dict(use_edinburgh_vctk_url=True, mic_id="mic1"))],
    ids=["recipes", "tranche6", "0.92-mic2", "0.92-mic1"])
def test_prepare_vctk_equals_jax(tmp_path, layout, kwargs):
    root = vctk_tree(tmp_path / "VCTK-Corpus", layout)
    ours, written = _both(tmp_path, pvctk.prepare_vctk, jvctk.prepare_vctk, root, **kwargs)
    assert set(written) == {"vctk_recordings_all.jsonl.gz", "vctk_supervisions_all.jsonl.gz"}
    sups = {s.id: s for s in ours["supervisions"]}
    if layout == "0.92":
        mic = kwargs.get("mic_id", "mic2")
        want = {"p225_001", "p225_002", "p362_001"} | (
            {"p280_001", "p280_002"} if mic == "mic1" else set())
        assert set(sups) == {f"{u}_{mic}" for u in want}
        assert sups[f"p225_001_{mic}"].custom["region"] == "Southern England"
        assert sups[f"p362_001_{mic}"].custom["region"] is None
        assert ours["recordings"][f"p225_001_{mic}"].sampling_rate == 48000
    else:
        assert sups["p225_001"].text == "Please call Stella."
        assert sups["p225_001"].custom["region"] == "Southern England"


def test_vctk_speaker_description_equals_jax(tmp_path):
    for layout, edinburgh in (("tranche6", False), ("0.92", True)):
        root = vctk_tree(tmp_path / layout, layout)
        assert pvctk._parse_speaker_description(root, edinburgh) == (
            jvctk._parse_speaker_description(root, edinburgh))
    for prepare in (pvctk.prepare_vctk, jvctk.prepare_vctk, pljspeech.prepare_ljspeech,
                    jljspeech.prepare_ljspeech):
        with pytest.raises(AssertionError):
            prepare(tmp_path / "no-such-dir")


# -- the slice: LibriTTS into the TTS dataset ---------------------------------------------


def _tts_batches(pkg, root):
    """Each package's chain: ``prepare_libritts`` → the cuts of dev-clean,
    resampled to 16 kHz → ``SpeechSynthesisDataset`` with ``OnTheFlyFeatures``,
    four cuts per batch, and the ``TokenCollater`` of all cuts on each."""
    if pkg == "port":
        made = plibritts.prepare_libritts(root, dataset_parts="dev-clean")
        CS, collater_cls = CutSet, TokenCollater
        dataset = SpeechSynthesisDataset(
            feature_input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu"))),
            return_cuts=True, return_spk_ids=True)
    else:
        made = jlibritts.prepare_libritts(root, dataset_parts="dev-clean")
        CS, collater_cls = J.CutSet, JTokenCollater
        # The JAX extractors' device route, in XLA on the CPU.
        dataset = JSynthesis(
            feature_input_strategy=JOnTheFly(JFbank(JFbankConfig(device="tpu"))),
            return_cuts=True, return_spk_ids=True)
    cuts = CS.from_manifests(**made["dev-clean"]).resample(16000).to_eager()
    collater = collater_cls(cuts)
    out = []
    for i in range(0, len(cuts), 4):
        batch_cuts = CS.from_cuts(list(cuts)[i:i + 4])
        batch = dataset[batch_cuts]
        batch["tokens"], batch["tokens_lens"] = collater(batch_cuts)
        out.append(batch)
    return out


def test_libritts_tts_chain_equals_jax(tmp_path):
    root = libritts_tree(tmp_path / "LibriTTS", "slice", n_chapters=2)
    ours, theirs = _tts_batches("port", root), _tts_batches("jax", root)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a["features"].shape == b["features"].shape and np.isfinite(a["features"]).all()
        np.testing.assert_allclose(a["features"], b["features"], rtol=0, atol=EXTRACTOR_TOL)
        for key in ("audio", "audio_lens", "features_lens", "tokens", "tokens_lens"):
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
        assert a["text"] == b["text"] and a["speakers"] == b["speakers"]
        assert [c.to_dict() for c in a["cut"]] == [c.to_dict() for c in b["cut"]]
        assert all(c.sampling_rate == 16000 for c in a["cut"])
    # 24 kHz audio resampled: 16,000 samples a second.
    cut = ours[0]["cut"][0]
    assert ours[0]["audio_lens"][0] == round(cut.duration * 16000)
    assert ours[0]["text"][0].startswith("Say 0, Doctor")
