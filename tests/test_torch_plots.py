"""
The port's plots and playback (``Cut.plot_audio``, ``play_audio``,
``plot_features``, ``plot_alignment``, ``MixedCut.plot_tracks_features``
and ``plot_tracks_audio``, ``Image.plot`` and ``dataset/vis.py::plot_batch``)
against the JAX package's, under matplotlib's Agg backend: the line, image,
span and text data of every axes are equal exactly, and so are the
``IPython.display.Audio`` data and rate. ``plot_alignment`` computes a
fresh fbank: the port's on the device it is given (the card unless the
caller asks for the CPU), so its spectrogram is held to JAX's CPU route
within ``ALIGNMENT_TOL`` while every position drawn over it is exact.
matplotlib and IPython import here; the card's machine has neither, so
these legs run only in the CPU tests.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lhotse_tpu as J  # noqa: E402
from lhotse_tpu.audio.backend import save_audio as jsave_audio  # noqa: E402
from lhotse_tpu.dataset.vis import plot_batch as jplot_batch  # noqa: E402
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank  # noqa: E402
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig  # noqa: E402
from lhotse_tpu.image.io import PillowInMemoryWriter as JPillowInMemoryWriter  # noqa: E402
from lhotse_tpu.utils import fix_random_seed as jfix  # noqa: E402
from lhotse_tpu_torch.cut import CutSet  # noqa: E402
from lhotse_tpu_torch.dataset.vis import plot_batch  # noqa: E402
from lhotse_tpu_torch.image import Image  # noqa: E402

SR = 16000
# The port's CPU fbank route against JAX's XLA route on the CPU, on noise:
# both are within ~1e-4 of a float64 chain.
ALIGNMENT_TOL = 5e-4  # measured: 1.4e-4


def _artists(fig) -> list:
    """Every axes' lines, images, span patches and texts, in data terms."""
    out = []
    for ax in fig.axes:
        out.append({
            "lines": [line.get_xydata().tolist() for line in ax.lines],
            "images": [np.asarray(im.get_array()).tolist() for im in ax.images],
            "clim": [im.get_clim() for im in ax.images],
            "patches": [p.get_patch_transform().transform(p.get_path().vertices).tolist()
                        for p in ax.patches],
            "texts": [(t.get_position(), t.get_text()) for t in ax.texts],
            "limits": (ax.get_xlim(), ax.get_ylim()),
            "title": ax.get_title()})
    return out


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def cuts(tmp_path_factory):
    """A 1.5 s mono FLAC cut of noise with two supervisions (word
    alignments on the first) and stored features, a second 1.0 s cut with
    stored features, and their mix; the port's cuts read from the JAX cuts'
    dicts."""
    root = tmp_path_factory.mktemp("plots")
    rng = np.random.default_rng(37)
    jcuts = []
    with J.LilcomChunkyWriter(root / "feats") as writer:
        for name, seconds in (("a", 1.5), ("b", 1.0)):
            jsave_audio(root / f"{name}.flac",
                        (0.1 * rng.standard_normal((1, int(SR * seconds)))).astype(np.float32), SR)
            cut = J.Recording.from_file(root / f"{name}.flac", recording_id=name).to_cut()
            cut = cut.compute_and_store_features(JFbank(JFbankConfig()), storage=writer)
            jcuts.append(cut)
    word = J.AlignmentItem
    jcuts[0].supervisions = [
        J.SupervisionSegment(id="s0", recording_id="a", start=0.1, duration=0.8, text="hello there",
                             speaker="spk", language="English",
                             alignment={"word": [word("hello", 0.1, 0.3), word("there", 0.5, 0.4)]}),
        J.SupervisionSegment(id="s1", recording_id="a", start=1.0, duration=0.7, text="x")]
    jcuts[1].supervisions = [
        J.SupervisionSegment(id="s2", recording_id="b", start=0.2, duration=0.5, text="y")]
    jfix(0)
    jcuts.append(jcuts[0].mix(jcuts[1], offset_other_by=0.4, snr=10))
    ours = CutSet.from_dicts([c.to_dict() for c in jcuts])
    return list(ours), jcuts


def test_plot_audio_equals_jax(cuts):
    ours, theirs = cuts
    for o, j in zip(ours, theirs):
        ax, jax_ax = o.plot_audio(), j.plot_audio()
        assert _artists(ax.figure) == _artists(jax_ax.figure)
        assert len(ax.patches) == len(o.supervisions) and len(ax.lines) == 1


def test_play_audio_equals_jax(cuts):
    ours, theirs = cuts
    for o, j in zip(ours, theirs):
        audio, jaudio = o.play_audio(), j.play_audio()
        assert audio.data == jaudio.data
        assert int.from_bytes(audio.data[24:28], "little") == SR  # the WAV header's rate


def test_plot_features_equals_jax(cuts):
    ours, theirs = cuts
    for o, j in zip(ours[:2], theirs[:2]):
        image, jimage = o.plot_features(), j.plot_features()
        assert np.array_equal(image.get_array(), jimage.get_array())
        assert _artists(image.figure) == _artists(jimage.figure)


def test_plot_tracks_equal_jax(cuts):
    ours, theirs = cuts
    axes, jaxes = ours[2].plot_tracks_audio(), theirs[2].plot_tracks_audio()
    assert len(axes) == 2 and _artists(axes[0].figure) == _artists(jaxes[0].figure)
    axes, jaxes = ours[2].plot_tracks_features(), theirs[2].plot_tracks_features()
    assert len(axes) == 2 and _artists(axes[0].figure) == _artists(jaxes[0].figure)


def test_plot_alignment_on_the_cpu_equals_jax(cuts):
    ours, theirs = cuts
    one = ours[0].filter_supervisions(lambda s: s.id == "s0")
    jone = theirs[0].filter_supervisions(lambda s: s.id == "s0")
    image = one.plot_alignment(device="cpu")
    mine = _artists(image.figure)
    jimage = jone.plot_alignment()
    theirs_art = _artists(jimage.figure)
    err = np.abs(np.asarray(image.get_array()) - np.asarray(jimage.get_array())).max()
    assert err <= ALIGNMENT_TOL, err
    for a, b in zip(mine, theirs_art):
        for key in ("lines", "texts", "title"):
            assert a[key] == b[key]
    assert [t[1] for t in mine[0]["texts"]] == ["hello", "there"]
    with pytest.raises(AssertionError, match="exactly one supervision"):
        ours[0].plot_alignment(device="cpu")


def test_plot_alignment_reaches_the_card_by_default(cuts):
    """The default device is the card: without CUDA the fbank raises, it
    does not fall back to the CPU."""
    one = cuts[0][0].filter_supervisions(lambda s: s.id == "s0")
    if torch.cuda.is_available():
        assert one.plot_alignment().get_array().shape[1] == 150
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            one.plot_alignment()


def test_image_plot_equals_jax():
    pixels = np.random.default_rng(5).integers(0, 256, size=(12, 10, 3), dtype=np.uint8)
    theirs = JPillowInMemoryWriter().store_image("k", pixels)
    ours = Image.from_dict(theirs.to_dict())
    ax, jax_ax = ours.plot(), theirs.plot()
    assert _artists(ax.figure) == _artists(jax_ax.figure)
    assert np.array_equal(ax.images[0].get_array(), pixels) and not ax.axison


def _batch(kind: str) -> dict:
    rng = np.random.default_rng(6)
    sups = {"sequence_idx": np.array([0, 1, 1]), "text": ["a", "b", "c"]}
    if kind == "features":
        sups.update(start_frame=np.array([0, 5, 40]), num_frames=np.array([50, 20, 30]))
        return {"features": rng.standard_normal((2, 80, 16)).astype(np.float32),
                "supervisions": sups}
    if kind == "inputs":
        sups.update(start_frame=np.array([0, 5, 40]), num_frames=np.array([50, 20, 30]))
        return {"inputs": rng.standard_normal((2, 80, 16)).astype(np.float32),
                "supervisions": sups}
    sups.update(start_sample=np.array([0, 800, 4000]), num_samples=np.array([4000, 1600, 2000]))
    audio = rng.standard_normal((2, 2, 8000)) if kind == "multi" else rng.standard_normal((2, 8000))
    return {"audio": (0.3 * audio).astype(np.float32), "supervisions": sups}


@pytest.mark.parametrize("kind", ["features", "inputs", "audio", "multi"])
def test_plot_batch_equals_jax(kind):
    batch = _batch(kind)
    fig, jfig = plot_batch(batch), jplot_batch(batch)
    assert _artists(fig) == _artists(jfig)
    assert sum(len(ax.patches) for ax in fig.axes) == 3
    fig = plot_batch(batch, supervisions=False)
    assert sum(len(ax.patches) for ax in fig.axes) == 0


def test_plot_batch_refusals_equal_jax():
    two_d = {"inputs": np.zeros((2, 100), np.float32)}
    with pytest.raises(NotImplementedError):
        plot_batch(two_d)
    with pytest.raises(NotImplementedError):
        jplot_batch(two_d)
    bad = {"features": np.zeros((1, 10, 4), np.float32),
           "supervisions": {"sequence_idx": np.array([0])}}
    with pytest.raises(ValueError, match="Cannot plot supervisions"):
        plot_batch(bad)
    with pytest.raises(ValueError, match="Cannot plot supervisions"):
        jplot_batch(bad)
