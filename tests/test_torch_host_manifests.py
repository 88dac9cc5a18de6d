"""
The port's manifests and audio I/O (lhotse_tpu_torch's serialization,
lazy, audio, supervision and cut modules) against the JAX package's on the
same files: manifests written by one package load in the other with equal
``to_dict()``, decoded audio is bit-identical, ``write_flac`` writes the
same bytes, and manifest fields the port does not have raise.
"""
import gzip
import json
from types import SimpleNamespace

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import read_flac as jread_flac
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.audio.wavio import write_wav as jwrite_wav
from lhotse_tpu.supervision import AlignmentItem as JAlignmentItem
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import read_flac, write_flac
from lhotse_tpu_torch.audio.wavio import write_wav
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment

SR = 16000
PORT = SimpleNamespace(
    Recording=Recording, SupervisionSegment=SupervisionSegment, CutSet=CutSet,
    AlignmentItem=AlignmentItem, write_flac=write_flac, write_wav=write_wav)
JAX = SimpleNamespace(
    Recording=J.Recording, SupervisionSegment=J.SupervisionSegment, CutSet=J.CutSet,
    AlignmentItem=JAlignmentItem, write_flac=jwrite_flac, write_wav=jwrite_wav)


def _signal(rng, n, channels=1):
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t) + 0.01 * rng.standard_normal((channels, n))
    return x.astype(np.float32)


def _write_corpus(root, pkg):
    """12 mono cuts, FLAC and WAV alternating, written with ``pkg``'s
    codecs and manifests; two cuts carry two supervisions, one an
    alignment, one a custom field."""
    rng = np.random.default_rng(11)
    cuts = []
    for i in range(12):
        n = int(SR * rng.uniform(0.3, 1.7))
        path = root / f"utt{i:02d}.{'flac' if i % 2 == 0 else 'wav'}"
        (pkg.write_flac if i % 2 == 0 else pkg.write_wav)(str(path), _signal(rng, n)[0], SR)
        cut = pkg.Recording.from_file(path).to_cut()
        half = round(cut.duration / 2, 3)
        sups = [pkg.SupervisionSegment(id=f"sup{i:02d}", recording_id=cut.recording_id, start=0.0,
                                       duration=half if i in (3, 8) else cut.duration,
                                       text=f"utterance {i}", speaker=f"spk{i % 3}")]
        if i in (3, 8):
            sups.append(pkg.SupervisionSegment(
                id=f"sup{i:02d}b", recording_id=cut.recording_id, start=half,
                duration=round(cut.duration - half, 3), text="second half"))
        if i == 5:
            item = pkg.AlignmentItem
            sups[0] = sups[0].with_alignment("word", [item("utterance", 0.0, 0.2), item("5", 0.2, 0.1)])
        cut.supervisions.extend(sups)
        if i == 7:
            cut.custom = {"dialect": "north"}
        cuts.append(cut)
    return pkg.CutSet.from_cuts(cuts)


@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_corpus")
    cuts = _write_corpus(root, JAX)
    for ext in ("jsonl", "jsonl.gz"):
        cuts.to_file(root / f"cuts.{ext}")
    return root


@pytest.mark.parametrize("ext", ["jsonl", "jsonl.gz"])
def test_jax_written_manifest_loads_in_port(jax_corpus, ext):
    path = jax_corpus / f"cuts.{ext}"
    theirs = [c.to_dict() for c in J.CutSet.from_jsonl_lazy(path)]
    lazy = CutSet.from_jsonl_lazy(path)
    assert lazy.is_lazy
    ours = [c.to_dict() for c in lazy]
    assert len(ours) == 12 and ours == theirs
    assert [c.to_dict() for c in CutSet.from_file(path)] == theirs
    assert all(isinstance(c, MonoCut) for c in lazy)


@pytest.mark.parametrize("ext", ["jsonl", "jsonl.gz"])
def test_port_written_manifest_loads_in_jax(tmp_path, jax_corpus, ext):
    ours = _write_corpus(tmp_path, PORT)
    ours.to_file(tmp_path / f"cuts.{ext}")
    theirs = J.CutSet.from_file(tmp_path / f"cuts.{ext}")
    assert [c.to_dict() for c in theirs] == [c.to_dict() for c in ours]
    # Same manifest text as the JAX package writes for the same data.
    opener = gzip.open if ext.endswith("gz") else open
    with opener(tmp_path / f"cuts.{ext}", "rt") as f:
        port_lines = [json.loads(x) for x in f]
    with opener(jax_corpus / f"cuts.{ext}", "rt") as f:
        jax_lines = [json.loads(x) for x in f]
    for a, b in zip(port_lines, jax_lines):
        for d in (a, b):
            d["recording"]["sources"][0]["source"] = d["recording"]["sources"][0]["source"].rsplit("/", 1)[1]
    assert port_lines == jax_lines


def test_recording_from_file_equals_jax(jax_corpus):
    for path in sorted(jax_corpus.glob("utt*")):
        assert Recording.from_file(path).to_dict() == J.Recording.from_file(path).to_dict()


@pytest.mark.parametrize("caching", [False, True])
def test_load_audio_is_bit_identical(jax_corpus, caching):
    from lhotse_tpu import set_caching_enabled as jset
    from lhotse_tpu_torch.caching import set_caching_enabled

    set_caching_enabled(caching)
    jset(caching)
    try:
        pairs = list(zip(CutSet.from_file(jax_corpus / "cuts.jsonl"),
                         J.CutSet.from_file(jax_corpus / "cuts.jsonl")))
        for _ in range(2):  # the second pass reads through the decoded-audio LRU
            for ours, theirs in pairs:
                a, b = ours.load_audio(), theirs.load_audio()
                assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), ours.id
                for offset, duration in [(0.1, 0.25), (0.0, 0.2), (0.05, None)]:
                    a = ours.recording.load_audio(offset=offset, duration=duration)
                    b = theirs.recording.load_audio(offset=offset, duration=duration)
                    assert np.array_equal(a, b), (ours.id, offset, duration)
    finally:
        set_caching_enabled(False)
        jset(False)


@pytest.mark.parametrize("channels,bits", [(1, 16), (2, 16), (1, 24)])
def test_write_flac_bytes_equal_jax(tmp_path, channels, bits):
    x = _signal(np.random.default_rng(channels + bits), 20000, channels)
    write_flac(str(tmp_path / "port.flac"), x, SR, bits_per_sample=bits)
    jwrite_flac(str(tmp_path / "jax.flac"), x, SR, bits_per_sample=bits)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()
    samples, sr = read_flac(tmp_path / "port.flac")
    assert sr == SR and samples.shape == (channels, 20000)
    assert np.array_equal(samples, jread_flac(tmp_path / "jax.flac")[0])


def _cut_line(jax_corpus):
    with open(jax_corpus / "cuts.jsonl") as f:
        return json.loads(f.readline())


def test_manifest_fields_the_port_lacks_raise(tmp_path, jax_corpus):
    line = _cut_line(jax_corpus)
    # Image manifests are ported: a custom image reads as the JAX package
    # reads it (tests/test_torch_images.py holds the pixels to JAX).
    path = tmp_path / "custom_image.jsonl"
    path.write_text(json.dumps(dict(line, custom={"img": {
        "storage_type": "pillow_files", "storage_path": "x", "storage_key": "y", "width": 4,
        "height": 4}})) + "\n")
    (with_image,) = list(CutSet.from_jsonl_lazy(path))
    (jwith_image,) = list(J.CutSet.from_jsonl_lazy(path))
    assert type(with_image.img).__name__ == "Image"
    assert with_image.to_dict() == jwith_image.to_dict()
    # The Compress transform is ported: a recording that carries it reads as
    # the JAX package reads it.
    path = tmp_path / "transforms.jsonl"
    path.write_text(json.dumps(dict(line, recording=dict(
        line["recording"], transforms=[{"name": "Compress", "kwargs": {"codec": "opus"}}]))) + "\n")
    (compressed,) = list(CutSet.from_jsonl_lazy(path))
    (jcompressed,) = list(J.CutSet.from_jsonl_lazy(path))
    assert compressed.to_dict() == jcompressed.to_dict()
    # MultiCut is ported: its manifest reads as the JAX package reads it.
    path = tmp_path / "MultiCut.jsonl"
    path.write_text(json.dumps(dict(line, type="MultiCut")) + "\n")
    (multi,) = list(CutSet.from_jsonl_lazy(path))
    (jmulti,) = list(J.CutSet.from_jsonl_lazy(path))
    assert type(multi).__name__ == "MultiCut" and multi.to_dict() == jmulti.to_dict()
    # Features and custom arrays load since the precomputed-features path was
    # ported; the HDF5 stores are ported too, so a store that is not there
    # raises when the data is read, as the JAX package's does.
    hdf5 = dict(line, features={
        "type": "kaldi-fbank", "num_frames": 100, "num_features": 80, "frame_shift": 0.01,
        "sampling_rate": SR, "start": 0.0, "duration": 1.0, "storage_type": "lilcom_hdf5",
        "storage_path": "x", "storage_key": "y", "channels": 0},
        custom={"emb": {"storage_type": "numpy_hdf5", "storage_path": "x", "storage_key": "y",
                        "shape": [4]}})
    path = tmp_path / "hdf5.jsonl"
    path.write_text(json.dumps(hdf5) + "\n")
    (cut,) = list(CutSet.from_jsonl_lazy(path))
    (jcut,) = list(J.CutSet.from_jsonl_lazy(path))
    assert cut.has_features and cut.emb.shape == [4]
    for load in ("load_features", "load_emb"):
        with pytest.raises(FileNotFoundError) as ours:
            getattr(cut, load)()
        with pytest.raises(FileNotFoundError) as theirs:
            getattr(jcut, load)()
        assert str(ours.value) == str(theirs.value)
    # Shar is ported: an unfilled placeholder is an error of the data, not a
    # part left out.
    shar = dict(line, recording=dict(line["recording"], sources=[
        {"type": "shar", "channels": [0], "source": ""}]))
    path = tmp_path / "shar.jsonl"
    path.write_text(json.dumps(shar) + "\n")
    (cut,) = list(CutSet.from_jsonl_lazy(path))
    assert cut.recording.is_placeholder
    with pytest.raises(RuntimeError, match="Shar placeholder") as raised:
        cut.load_audio()
    assert not isinstance(raised.value, NotImplementedError)
    # A recording with a narrowband transform, built in the JAX package: the
    # port reads it and loads the same audio.
    cut = J.CutSet.from_file(jax_corpus / "cuts.jsonl")[0]
    theirs = cut.perturb_speed(1.1).narrowband("mulaw")
    J.CutSet.from_cuts([theirs]).to_file(tmp_path / "nb.jsonl")
    (ours,) = list(CutSet.from_file(tmp_path / "nb.jsonl"))
    assert ours.to_dict() == theirs.to_dict()
    assert np.array_equal(ours.load_audio(), theirs.load_audio())


def test_lazy_cutset_algebra_equals_jax(jax_corpus):
    import random

    ours = CutSet.from_jsonl_lazy(jax_corpus / "cuts.jsonl.gz")
    theirs = J.CutSet.from_jsonl_lazy(jax_corpus / "cuts.jsonl.gz")

    def ids(cs):
        return [c.id for c in cs]

    assert ids(ours.filter(lambda c: c.duration > 0.8)) == ids(theirs.filter(lambda c: c.duration > 0.8))
    assert ids(ours.shuffle(random.Random(3), buffer_size=5)) == ids(
        theirs.shuffle(random.Random(3), buffer_size=5))
    assert ids(ours.repeat(2)) == ids(theirs.repeat(2))
    assert ids(ours + ours) == ids(theirs + theirs)
    assert ids(ours.to_eager().sort_by_duration()) == ids(theirs.to_eager().sort_by_duration())
    assert ids(ours.subset(first=4)) == ids(theirs.subset(first=4))
    assert [ids(s) for s in ours.to_eager().split(3)] == [ids(s) for s in theirs.to_eager().split(3)]
    assert ids(ours.to_eager().modify_ids(lambda i: i + "_x")) == ids(
        theirs.to_eager().modify_ids(lambda i: i + "_x"))
    assert ids(ours.map(lambda c: c.with_id("m" + c.id))) == ids(theirs.map(lambda c: c.with_id("m" + c.id)))
