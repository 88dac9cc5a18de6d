"""
The port's LibriSpeech recipe and its manifest caching
(lhotse_tpu_torch.recipes) against the JAX package's on the fixture layout
of tests/test_recipes_tranche5.py, and the recipe path as a whole at a
small size: corpus directory → ``prepare_librispeech`` →
``CutSet.from_manifests`` → ``trim_to_supervisions`` →
``compute_and_store_features`` (the port's CPU route of the fbank kernel,
stored losslessly) → ``SimpleCutSampler`` → ``K2SpeechRecognitionDataset``,
against the same chain in the JAX package.

Written ``.jsonl.gz`` manifests are compared after decompression, since a
gzip header carries its write time.
"""
import gzip
import logging

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.dataset.sampling import SimpleCutSampler as JSimple
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.io import NumpyFilesWriter as JNumpyFilesWriter
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import librispeech as jlibrispeech
from lhotse_tpu.recipes import utils as jrecipe_utils
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import SimpleCutSampler
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.features.io import NumpyFilesWriter
from lhotse_tpu_torch.recipes import librispeech as plibrispeech
from lhotse_tpu_torch.recipes import utils as precipe_utils
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import fix_random_seed

SR = 16000
# The extractor's bound against the JAX device route (tests/test_torch_precomputed.py).
EXTRACTOR_TOL = 3e-4
PARTS = ("dev-clean", "test-clean")


def _sig(seconds, seed=0):
    rng = np.random.RandomState(seed)
    return (0.1 * rng.randn(int(SR * seconds))).astype(np.float32)


@pytest.fixture
def librispeech_root(tmp_path):
    """The layout of tests/test_recipes_tranche5.py::librispeech_root: two
    splits, three chapters, four utterances, word alignments for one
    chapter."""
    root = tmp_path / "LibriSpeech"
    for split, spk, chap, utts in [
        ("dev-clean", "84", "121123", ["0000", "0001"]),
        ("dev-clean", "174", "50561", ["0000"]),
        ("test-clean", "1089", "134686", ["0000"]),
    ]:
        chap_dir = root / split / spk / chap
        chap_dir.mkdir(parents=True, exist_ok=True)
        lines = []
        for i, utt in enumerate(utts):
            utt_id = f"{spk}-{chap}-{utt}"
            jwrite_flac(str(chap_dir / f"{utt_id}.flac"), _sig(1.0 + 0.5 * i, seed=i), SR)
            lines.append(f"{utt_id} HELLO WORLD NUMBER {utt}")
        (chap_dir / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    ali_dir = root / "dev-clean" / "84" / "121123"
    (ali_dir / "84-121123.alignment.txt").write_text(
        '84-121123-0000 "HELLO,WORLD,NUMBER,0000" "0.25,0.5,0.75,1.0"\n'
    )
    return root


def _dicts(manifest) -> list:
    return [item.to_dict() for item in manifest]


def _as_dicts(manifests) -> dict:
    return {part: {k: _dicts(m) for k, m in pair.items()} for part, pair in manifests.items()}


def _decompressed(directory) -> dict:
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(directory.glob("*.jsonl.gz"))}


@pytest.mark.parametrize("kwargs", [
    dict(), dict(dataset_parts="dev-clean"), dict(dataset_parts=["test-clean"]),
    dict(normalize_text="lower"), dict(num_jobs=2)])
def test_prepare_librispeech_equals_jax(librispeech_root, tmp_path, kwargs):
    ours = plibrispeech.prepare_librispeech(
        librispeech_root, output_dir=tmp_path / "ours", **kwargs)
    theirs = jlibrispeech.prepare_librispeech(
        librispeech_root, output_dir=tmp_path / "jax", **kwargs)
    assert _as_dicts(ours) == _as_dicts(theirs)
    written = _decompressed(tmp_path / "ours")
    assert written == _decompressed(tmp_path / "jax") and len(written) == 2 * len(ours)
    for pair in ours.values():
        assert type(pair["recordings"]) is RecordingSet
        assert type(pair["supervisions"]) is SupervisionSet
    if kwargs.get("normalize_text") == "lower":
        assert all(s.text == s.text.lower() for p in ours.values() for s in p["supervisions"])


def test_prepare_librispeech_without_output_dir_and_with_alignments_dir(librispeech_root):
    ours = plibrispeech.prepare_librispeech(librispeech_root, alignments_dir=librispeech_root)
    theirs = jlibrispeech.prepare_librispeech(librispeech_root, alignments_dir=librispeech_root)
    assert _as_dicts(ours) == _as_dicts(theirs)
    sups = ours["dev-clean"]["supervisions"]
    # The supervisions follow the sorted transcript files: the order the
    # lazy CutSet.from_manifests join needs.
    assert [s.id for s in sups] == ["174-50561-0000", "84-121123-0000", "84-121123-0001"]
    assert [r.id for r in ours["dev-clean"]["recordings"]] == [s.id for s in sups]
    ali = sups["84-121123-0000"].alignment["word"]
    assert [(a.symbol, a.start) for a in ali][:2] == [("HELLO", 0.0), ("WORLD", 0.25)]
    assert sups["84-121123-0001"].alignment is None


def test_prepare_librispeech_reads_the_jax_cache(librispeech_root, tmp_path, caplog):
    """A second run returns the cached manifests without scanning audio,
    whichever package wrote them."""
    out = tmp_path / "manifests"
    first = jlibrispeech.prepare_librispeech(librispeech_root, output_dir=out)
    for flac in librispeech_root.rglob("*.flac"):
        flac.unlink()
    with caplog.at_level(logging.WARNING):
        cached = plibrispeech.prepare_librispeech(librispeech_root, output_dir=out)
    assert _as_dicts(cached) == _as_dicts(first)
    assert not any("No such file" in m for m in caplog.messages)


def test_prepare_librispeech_missing_split_raises(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for prepare in (plibrispeech.prepare_librispeech, jlibrispeech.prepare_librispeech):
        with pytest.raises(ValueError):
            prepare(empty)
        with pytest.raises(AssertionError):
            prepare(tmp_path / "no-such-dir")
        assert prepare(empty, dataset_parts="mini_librispeech") == {}


def test_recipe_utils_equal_jax(librispeech_root, tmp_path):
    jlibrispeech.prepare_librispeech(librispeech_root, output_dir=tmp_path, dataset_parts="dev-clean")
    for lazy in (False, True):
        ours = precipe_utils.read_manifests_if_cached(
            dataset_parts=PARTS, output_dir=tmp_path, prefix="librispeech", lazy=lazy)
        theirs = jrecipe_utils.read_manifests_if_cached(
            dataset_parts=PARTS, output_dir=tmp_path, prefix="librispeech", lazy=lazy)
        assert _as_dicts(ours) == _as_dicts(theirs) and set(ours) == {"dev-clean"}
        assert all(m.is_lazy == lazy for m in ours["dev-clean"].values())
    for part in PARTS:
        assert precipe_utils.manifests_exist(part, tmp_path, prefix="librispeech") == (
            jrecipe_utils.manifests_exist(part, tmp_path, prefix="librispeech"))
    assert precipe_utils.read_manifests_if_cached(PARTS, None) is None
    with pytest.raises(ValueError, match="lazily"):
        precipe_utils.read_manifests_if_cached(PARTS, tmp_path, suffix="json", lazy=True)
    recs = RecordingSet.from_file(tmp_path / "librispeech_recordings_dev-clean.jsonl.gz")
    sups = SupervisionSet.from_file(tmp_path / "librispeech_supervisions_dev-clean.jsonl.gz")
    ours = precipe_utils.finalize_manifests(
        list(recs), list(sups), output_dir=tmp_path / "ours", prefix="x", part="p")
    theirs = jrecipe_utils.finalize_manifests(
        list(J.RecordingSet.from_file(tmp_path / "librispeech_recordings_dev-clean.jsonl.gz")),
        list(J.SupervisionSet.from_file(tmp_path / "librispeech_supervisions_dev-clean.jsonl.gz")),
        output_dir=tmp_path / "jax", prefix="x", part="p")
    assert {k: _dicts(v) for k, v in ours.items()} == {k: _dicts(v) for k, v in theirs.items()}
    assert _decompressed(tmp_path / "ours") == _decompressed(tmp_path / "jax")


def _recipe_batches(pkg, corpus, workdir):
    """The recipe path in one package: the prepared manifests → lazy cuts →
    one cut per supervision → fbank stored as .npy files → the sampler →
    the dataset's batches."""
    if pkg == "port":
        prepare, CS, Sampler, Dataset = (
            plibrispeech.prepare_librispeech, CutSet, SimpleCutSampler, K2SpeechRecognitionDataset)
        extractor, writer = Fbank(FbankConfig(device="cpu")), NumpyFilesWriter
        fix_random_seed(0)
    else:
        prepare, CS, Sampler, Dataset = (
            jlibrispeech.prepare_librispeech, J.CutSet, JSimple, JDataset)
        # The JAX extractors' device route, in XLA on the CPU.
        extractor, writer = JFbank(JFbankConfig(device="tpu")), JNumpyFilesWriter
        jfix(0)
    manifests = prepare(corpus, output_dir=workdir / "manifests")
    batches = []
    for part in PARTS:
        cuts = CS.from_manifests(
            **manifests[part], lazy=True, output_path=workdir / f"cuts_{part}.jsonl.gz")
        trimmed = cuts.trim_to_supervisions(keep_overlapping=False, min_duration=1.2)
        featured = trimmed.compute_and_store_features(
            extractor, workdir / f"feats_{part}", storage_type=writer, progress_bar=False)
        sampler = Sampler(featured, max_duration=3.0, shuffle=True, seed=0)
        batches += [Dataset(return_cuts=True)[b] for b in sampler]
    return batches


def _portable(cut) -> dict:
    """The cut's dict without where its features were written."""
    d = cut.to_dict()
    d["features"] = {k: v for k, v in d["features"].items() if k != "storage_path"}
    return d


def test_recipe_path_equals_jax(librispeech_root, tmp_path):
    ours = _recipe_batches("port", librispeech_root, tmp_path / "ours")
    theirs = _recipe_batches("jax", librispeech_root, tmp_path / "jax")
    assert len(ours) == len(theirs) == 3
    for got, want in zip(ours, theirs):
        assert got["inputs"].shape == want["inputs"].shape and got["inputs"].shape[2] == 80
        assert np.isfinite(got["inputs"]).all()
        np.testing.assert_allclose(got["inputs"], want["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        sups, jsups = got["supervisions"], want["supervisions"]
        for key in ("sequence_idx", "start_frame", "num_frames"):
            np.testing.assert_array_equal(sups[key], jsups[key])
        assert sups["text"] == jsups["text"]
        assert [_portable(c) for c in sups["cut"]] == [_portable(c) for c in jsups["cut"]]
    texts = sorted(t for b in ours for t in b["supervisions"]["text"])
    assert texts == ["HELLO WORLD NUMBER 0000"] * 3 + ["HELLO WORLD NUMBER 0001"]
