"""
The port's HuggingFace bridges (``lhotse_tpu_torch/hf.py``,
``CutSet.to_huggingface_dataset`` and ``from_huggingface_dataset``)
against the JAX package's. Every dataset is built in memory
(``Dataset.from_dict`` or the export itself); no hub name is loaded. The
exported rows and features, and the cuts read back through
``LazyHFDatasetIterator`` (their manifests, audio and custom fields, an
image column among them), must equal JAX's exactly, but where the port
keeps a JAX fault out (ROADMAP C2).
"""
import io

import numpy as np
import pytest
from datasets import Audio, Dataset, Features, Value
from datasets import Image as HFImage
from PIL import Image as PILImage

import lhotse_tpu as J
from lhotse_tpu import hf as jhf
from lhotse_tpu.audio.backend import save_audio as jsave_audio
from lhotse_tpu_torch import hf as phf
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.image import Image

SR = 16000


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four WAV recordings of 0.5-1.2 s written by the JAX package."""
    root = tmp_path_factory.mktemp("hf")
    rng = np.random.default_rng(36)
    paths = []
    for i in range(4):
        x = (rng.standard_normal((1, int(SR * rng.uniform(0.5, 1.2)))) * 0.1).astype(np.float32)
        paths.append(root / f"rec{i}.wav")
        jsave_audio(paths[-1], x, SR)
    return paths


def _cuts(package, paths, per_cut: int, alignments: bool = False):
    cuts = []
    for i, path in enumerate(paths):
        cut = package.Recording.from_file(path).to_cut()
        step = cut.duration / per_cut
        word = package.AlignmentItem
        cut.supervisions = [
            package.SupervisionSegment(
                id=f"sup{i}-{k}", recording_id=cut.recording_id, start=k * step, duration=step,
                text=f"utterance {i} {k}", speaker=f"spk{i % 2}",
                language="English" if i % 2 else None,
                alignment={"word": [word(symbol="a", start=k * step, duration=step / 2),
                                    word(symbol="b", start=k * step + step / 2,
                                         duration=step / 2)]} if alignments else None)
            for k in range(per_cut)]
        cuts.append(cut)
    return package.CutSet.from_cuts(cuts)


def _rows(dataset) -> tuple:
    undecoded = dataset.cast_column("audio", Audio(decode=False))
    return [dict(row) for row in undecoded], undecoded.features.to_dict()


def test_export_rows_and_features_equal_jax(files):
    theirs = _cuts(J, files, 1)
    ours = CutSet.from_dicts([c.to_dict() for c in theirs])
    exported = ours.to_huggingface_dataset()
    assert isinstance(exported, Dataset) and len(exported) == len(files)
    assert _rows(exported) == _rows(theirs.to_huggingface_dataset())
    assert _rows(exported) == _rows(jhf.export_cuts_to_hf(theirs))
    rows, _ = _rows(exported)
    assert [r["audio"]["path"] for r in rows] == [str(p) for p in files]
    assert [r["text"] for r in rows] == [f"utterance {i} 0" for i in range(len(files))]
    assert phf.contains_only_mono_cuts(ours) and phf.has_one_audio_source(ours)
    assert phf.has_one_supervision_per_cut(ours)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares what each package raises
        return type(e).__name__, str(e)


@pytest.mark.parametrize("per_cut,alignments", [(2, False), (1, True), (2, True)],
                         ids=["segments", "alignments", "segments_alignments"])
def test_export_of_nested_supervisions_where_jax_raises(files, per_cut, alignments):
    """JAX declares the ``segments`` of a cut with several supervisions, and
    the alignment items, as ``Sequence(Features(...))``, a struct of lists
    to ``datasets``, which refuses the lists of dicts it is given: JAX
    raises. The port declares lists of structs and exports the rows of
    ``convert_supervisions_info_to_hf`` (ROADMAP C2)."""
    theirs = _cuts(J, files, per_cut, alignments)
    ours = CutSet.from_dicts([c.to_dict() for c in theirs])
    assert phf.has_one_supervision_per_cut(ours) == (per_cut == 1)
    raised = _raised(theirs.to_huggingface_dataset)
    assert raised is not None and raised[0] == "AttributeError"
    rows, features = _rows(ours.to_huggingface_dataset())
    sup_dicts, _ = phf.convert_supervisions_info_to_hf(
        ours, None if per_cut > 1 else {"start", "end", "channel"})
    f32 = lambda v: float(np.float32(v)) if isinstance(v, float) else v  # noqa: E731
    cast = lambda d: {k: ([{kk: f32(vv) for kk, vv in x.items()} for x in v]  # noqa: E731
                          if isinstance(v, list) else f32(v)) for k, v in d.items()}
    for row, sups in zip(rows, sup_dicts):
        got = row["segments"] if per_cut > 1 else [
            {k: row[k] for k in sups[0]}]
        assert got == [cast(s) for s in sups]
    nested = features["segments"]["feature"] if per_cut > 1 else features
    if alignments:
        assert nested["word_alignment"]["_type"] == "List"


def test_supervision_conversion_helpers_equal_jax(files):
    theirs = _cuts(J, files, 2, alignments=True)
    ours = CutSet.from_dicts([c.to_dict() for c in theirs])
    for exclude in (None, {"start", "end", "channel"}, {"alignments", "speaker"}):
        o_dicts, o_info = phf.convert_supervisions_info_to_hf(ours, exclude)
        j_dicts, j_info = jhf.convert_supervisions_info_to_hf(theirs, exclude)
        assert o_dicts == j_dicts and o_info.keys() == j_info.keys()
        for key in o_info:
            if key.endswith("_alignment"):  # a list of structs, a struct of lists in JAX
                (item,) = o_info[key]
                assert item.keys() == j_info[key].keys()
                assert all(repr(item[f]) == repr(j_info[key][f].feature) for f in item)
            else:
                assert repr(o_info[key]) == repr(j_info[key])
    o_info, o_desc = phf.convert_cuts_info_to_hf(ours)
    j_info, j_desc = jhf.convert_cuts_info_to_hf(theirs)
    assert o_info == j_info and repr(o_desc) == repr(j_desc)
    assert phf.lod_to_dol([{"a": 1, "b": 2}, {"a": 3, "b": 4}]) == {"a": [1, 3], "b": [2, 4]}


def _read_back(make_dataset, **kwargs) -> tuple:
    ours = list(CutSet.from_huggingface_dataset(make_dataset(), **kwargs))
    theirs = list(J.CutSet.from_huggingface_dataset(make_dataset(), **kwargs))
    return ours, theirs


def _custom(cut) -> dict:
    return {k: (v.to_dict() if hasattr(v, "to_dict") else v) for k, v in (cut.custom or {}).items()}


def test_export_then_read_back_equals_jax(files):
    theirs_cuts = _cuts(J, files, 1)
    ours_cuts = CutSet.from_dicts([c.to_dict() for c in theirs_cuts])
    ours, theirs = _read_back(ours_cuts.to_huggingface_dataset, text_key="text")
    assert len(ours) == len(theirs) == len(files)
    for o, j, orig in zip(ours, theirs, ours_cuts):
        assert o.to_dict() == j.to_dict()
        assert o.supervisions[0].text == orig.supervisions[0].text
        assert np.array_equal(o.load_audio(), j.load_audio())
        assert np.array_equal(o.load_audio(), orig.load_audio())


def _png(pixels) -> bytes:
    buf = io.BytesIO()
    PILImage.fromarray(pixels).save(buf, format="PNG")
    return buf.getvalue()


def test_in_memory_dataset_with_bytes_and_an_image_column_equals_jax(files):
    """Audio given as bytes (recording ids from their md5; the column is a
    plain struct that the iterator casts to ``Audio``, since encoding audio
    needs torchcodec here), the text, language and gender keys, an extra
    field and an image column, which both packages turn into
    ``pillow_memory`` Image manifests."""
    rng = np.random.default_rng(3)
    pixels = [rng.integers(0, 256, size=(6, 5, 3), dtype=np.uint8) for _ in files]

    def make():
        return Dataset.from_dict(
            {"audio": [{"bytes": p.read_bytes(), "path": None} for p in files],
             "sentence": [f"text {i}" for i in range(len(files))],
             "language": ["en", "de", "en", "fr"],
             "gender": ["f", "m", "m", "f"],
             "client": [f"c{i}" for i in range(len(files))],
             "picture": [{"bytes": _png(p), "path": None} for p in pixels]},
            features=Features(audio={"bytes": Value("binary"), "path": Value("string")},
                              sentence=Value("string"),
                              language=Value("string"), gender=Value("string"),
                              client=Value("string"), picture=HFImage()))

    ours, theirs = _read_back(make)
    for o, j, p, path in zip(ours, theirs, pixels, files):
        assert o.recording.sources[0].type == "memory"
        assert o.supervisions[0].to_dict() == j.supervisions[0].to_dict()
        assert o.recording.to_dict() == j.recording.to_dict()
        assert _custom(o) == _custom(j)
        assert isinstance(o.custom["picture"], Image)
        assert np.array_equal(o.load_custom("picture"), p)
        assert np.array_equal(o.load_audio(), j.load_audio())
        assert np.array_equal(o.load_audio(), J.Recording.from_file(path).load_audio())


def test_streaming_dataset_and_other_keys_equal_jax(files):
    def make():
        return Dataset.from_dict(
            {"speech": [str(p) for p in files], "transcript": ["x", "y", "z", "w"]},
            features=Features(speech=Value("string"), transcript=Value("string"))
        ).to_iterable_dataset()

    ours, theirs = _read_back(make, audio_key="speech", text_key="transcript")
    assert [o.to_dict() for o in ours] == [j.to_dict() for j in theirs]
    assert [o.supervisions[0].text for o in ours] == ["x", "y", "z", "w"]
