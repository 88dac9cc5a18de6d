"""
The port's CommonVoice recipe (lhotse_tpu_torch.recipes.commonvoice)
against the JAX package's on a local release layout, and the lossy-codec
corpus path as a whole at a small size: a CommonVoice MP3 corpus →
``prepare_commonvoice`` → ``CutSet.from_manifests`` → ``resample(16000)``
→ ``SimpleCutSampler`` → ``K2SpeechRecognitionDataset`` with the
``Compress`` cut transform and ``OnTheFlyFeatures`` (the port's CPU route
of the fbank kernel), against the same chain in the JAX package.

The layout is written inside the test: two languages, the three default
splits, 48 kHz mono MP3 clips encoded from numpy noise made from a seed, a
row whose clip is missing and a sentence with an unbalanced quote.
Written ``.jsonl.gz`` manifests are compared after decompression, since a
gzip header carries its write time. The features are held to the JAX
extractors' device route in XLA at ``EXTRACTOR_TOL``, the bound of
tests/test_torch_recipes.py.
"""
import gzip

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio import syscodecs as jsc
from lhotse_tpu.dataset import cut_transforms as JT
from lhotse_tpu.dataset.input_strategies import OnTheFlyFeatures as JOnTheFly
from lhotse_tpu.dataset.sampling import SimpleCutSampler as JSimple
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.recipes import commonvoice as jcv
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset import SimpleCutSampler
from lhotse_tpu_torch.dataset import cut_transforms as PT
from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.recipes import commonvoice as pcv
from lhotse_tpu_torch.recipes import prepare_commonvoice
from lhotse_tpu_torch.utils import fix_random_seed

pytestmark = pytest.mark.skipif(
    not (jsc.mp3_available() and jsc.mp3_encode_available() and jsc.vorbis_available()
         and jsc.vorbis_encode_available() and jsc.opus_available()),
    reason="the system codec libraries (mpg123, mp3lame, vorbis, opus, ogg) are not present")

RELEASE = "cv-corpus-13.0-2023-03-09"
EXTRACTOR_TOL = 3e-4
HEADER = "client_id\tpath\tsentence\tup_votes\tdown_votes\tage\tgender\taccents\tvariant\tlocale"
# Per language and split: the clips, as (clip number, seconds).
LAYOUT = {
    "en": {"train": [(0, 1.1), (1, 0.7), (2, 1.4), (3, 0.9), (4, 1.2), (5, 0.8)],
           "dev": [(10, 0.6), (11, 1.0)], "test": [(20, 0.9), (21, 0.5)]},
    "de": {"train": [(30, 0.8), (31, 1.3)], "dev": [(40, 0.7)], "test": [(50, 1.0)]},
}


def _clip(seed, seconds, sr=48000):
    """Band-limited noise with a slow envelope: speech-like to the codec."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    noise = rng.standard_normal(n)
    smooth = np.convolve(noise, np.ones(6) / 6, mode="same")
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * np.arange(n) / sr)
    return np.clip(0.2 * smooth * env, -0.99, 0.99).astype(np.float32)[None]


@pytest.fixture(scope="module")
def cv_root(tmp_path_factory):
    """``<release>/{en,de}/{train,dev,test}.tsv`` and ``clips/*.mp3``; the en
    train split names a clip that is not on disk, and one sentence opens a
    quote it never closes."""
    root = tmp_path_factory.mktemp("commonvoice") / RELEASE
    for lang, splits in LAYOUT.items():
        clips = root / lang / "clips"
        clips.mkdir(parents=True)
        for split, items in splits.items():
            rows = [HEADER]
            for k, seconds in items:
                name = f"common_voice_{lang}_{k:06d}.mp3"
                (clips / name).write_bytes(jsc.mp3_encode(_clip(k, seconds), 48000))
                sentence = f'He said "number {k}' if k == 1 else f"Sentence number {k}."
                rows.append(f"client{k % 3}\t{name}\t{sentence}\t2\t0\t"
                            f"{('twenties', 'fifties', '')[k % 3]}\t"
                            f"{('male', 'female', '')[k % 3]}\t{('us', '', 'england')[k % 3]}"
                            f"\t\t{lang}")
            if split == "train" and lang == "en":
                rows.append(f"client9\tcommon_voice_{lang}_999999.mp3\tMissing clip.\t1\t0\t\t\t\t\t{lang}")
            (root / lang / f"{split}.tsv").write_text("\n".join(rows) + "\n")
    return root


def _decompressed(directory):
    return {p.name: gzip.decompress(p.read_bytes()) for p in sorted(directory.glob("*.jsonl.gz"))}


def _dicts(manifest):
    return [item.to_dict() for item in manifest]


@pytest.mark.parametrize("languages,splits,num_jobs", [
    ("auto", ("test", "dev", "train"), 1), ("en", "train", 2), (["de", "en"], ("dev",), 3)])
def test_prepare_commonvoice_equals_jax(cv_root, tmp_path, languages, splits, num_jobs):
    ours = prepare_commonvoice(cv_root, tmp_path / "ours", languages=languages, splits=splits,
                               num_jobs=num_jobs)
    theirs = jcv.prepare_commonvoice(cv_root, tmp_path / "jax", languages=languages,
                                     splits=splits, num_jobs=num_jobs)
    assert sorted(ours) == sorted(theirs)
    for lang in ours:
        assert sorted(ours[lang]) == sorted(theirs[lang])
        for split in ours[lang]:
            for kind in ("recordings", "supervisions"):
                assert _dicts(ours[lang][split][kind]) == _dicts(theirs[lang][split][kind])
    assert _decompressed(tmp_path / "ours") == _decompressed(tmp_path / "jax")
    assert len(_decompressed(tmp_path / "ours")) == 2 * sum(len(ours[lang]) for lang in ours)


def test_prepare_commonvoice_fields(cv_root, tmp_path):
    out = prepare_commonvoice(cv_root, tmp_path, languages="en", splits="train")
    recs, sups = out["en"]["train"]["recordings"], out["en"]["train"]["supervisions"]
    # The missing clip is skipped; the unbalanced quote is kept as written.
    assert len(recs) == len(sups) == len(LAYOUT["en"]["train"])
    assert "common_voice_en_999999" not in [r.id for r in recs]
    by_id = {s.id: s for s in sups}
    assert by_id["common_voice_en_000001"].text == 'He said "number 1'
    rec = recs["common_voice_en_000002"]
    assert (rec.sampling_rate, rec.num_channels, rec.num_samples) == (48000, 1, int(48000 * 1.4))
    assert rec.sources[0].source.endswith(".mp3")
    sup = by_id["common_voice_en_000002"]
    assert (sup.language, sup.speaker, sup.gender) == ("en", "client2", "")
    assert sup.custom == {"age": "", "accents": "england", "variant": ""}


def test_prepared_manifests_are_read_back(cv_root, tmp_path):
    """A second call finds the written manifests and reads them, in both
    packages alike."""
    first = prepare_commonvoice(cv_root, tmp_path, languages="de")
    again = prepare_commonvoice(cv_root, tmp_path, languages="de")
    jagain = jcv.prepare_commonvoice(cv_root, tmp_path, languages="de")
    for split in first["de"]:
        for kind in ("recordings", "supervisions"):
            assert _dicts(again["de"][split][kind]) == _dicts(first["de"][split][kind])
            assert _dicts(jagain["de"][split][kind]) == _dicts(first["de"][split][kind])


def test_recipe_constants_equal_jax():
    assert pcv.COMMONVOICE_LANGS == jcv.COMMONVOICE_LANGS
    assert pcv.COMMONVOICE_SPLITS == jcv.COMMONVOICE_SPLITS
    assert pcv.COMMONVOICE_DEFAULT_SPLITS == jcv.COMMONVOICE_DEFAULT_SPLITS
    assert pcv.DEFAULT_COMMONVOICE_RELEASE == jcv.DEFAULT_COMMONVOICE_RELEASE
    assert not hasattr(pcv, "download_commonvoice")


COMPRESS = dict(codecs=["opus", "mp3", "vorbis"], compression_level=(0.1, 0.9), p=0.5, seed=3)


def _slice(pkg, corpus, workdir):
    """The lossy-codec corpus path in one package: the prepared en train
    split → cuts at 16 kHz → the sampler → the dataset with the Compress
    cut transform."""
    if pkg == "port":
        prepare, CS, Sampler, Dataset, Compress = (
            prepare_commonvoice, CutSet, SimpleCutSampler, K2SpeechRecognitionDataset, PT.Compress)
        strategy = OnTheFlyFeatures(Fbank(FbankConfig(device="cpu")))
        fix_random_seed(0)
    else:
        prepare, CS, Sampler, Dataset, Compress = (
            jcv.prepare_commonvoice, J.CutSet, JSimple, JDataset, JT.Compress)
        # The JAX extractors' device route, in XLA on the CPU.
        strategy = JOnTheFly(JFbank(JFbankConfig(device="tpu")))
        jfix(0)
    train = prepare(corpus, workdir, languages="en", splits="train")["en"]["train"]
    cuts = CS.from_manifests(**train).resample(16000)
    dataset = Dataset(return_cuts=True, cut_transforms=[Compress(**COMPRESS)],
                      input_strategy=strategy)
    sampler = Sampler(cuts, max_duration=2.5, shuffle=True, seed=0)
    return [dataset[b] for b in sampler]


def test_lossy_corpus_slice_equals_jax(cv_root, tmp_path):
    ours = _slice("port", cv_root, tmp_path / "ours")
    theirs = _slice("jax", cv_root, tmp_path / "jax")
    assert len(ours) == len(theirs) >= 3
    codecs = set()
    for got, want in zip(ours, theirs):
        assert got["inputs"].shape == want["inputs"].shape and got["inputs"].shape[2] == 80
        assert np.isfinite(got["inputs"]).all()
        np.testing.assert_allclose(got["inputs"], want["inputs"], rtol=0, atol=EXTRACTOR_TOL)
        sups, jsups = got["supervisions"], want["supervisions"]
        for key in ("sequence_idx", "start_frame", "num_frames"):
            np.testing.assert_array_equal(sups[key], jsups[key])
        assert sups["text"] == jsups["text"]
        assert [c.to_dict() for c in sups["cut"]] == [c.to_dict() for c in jsups["cut"]]
        for cut in sups["cut"]:
            assert cut.sampling_rate == 16000
            if len(cut.recording.transforms) > 1:
                codecs.add(cut.recording.transforms[-1]["kwargs"]["codec"]
                           if isinstance(cut.recording.transforms[-1], dict)
                           else cut.recording.transforms[-1].codec)
    assert codecs and codecs <= {"opus", "mp3", "vorbis"}
    texts = sorted(t for b in ours for t in b["supervisions"]["text"])
    assert texts == sorted(
        'He said "number 1' if k == 1 else f"Sentence number {k}."
        for k, _ in LAYOUT["en"]["train"])
