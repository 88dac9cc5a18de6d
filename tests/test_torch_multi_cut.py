"""
The port's MultiCut (lhotse_tpu_torch.cut.multi) and the multi-channel
parts of the cut algebra, the host WPE transform
(lhotse_tpu_torch.augmentation.wpe) and multi-channel features, against the
JAX package on the same files: every case of tests/test_multi_cut.py, and
the multi-channel cases of tests/test_cut_augmentation_matrix.py (RIR
fan-out, WPE on mono and multi cuts).

Audio goes through the same numpy code on both sides and is compared
exactly, manifests as dicts. Where the port departs from the JAX package on
purpose (a channel subset read through WPE or a multi-channel RIR,
multi-channel feature storage, ``extract_batch`` on multi-channel items),
the test shows what the JAX package gives and holds the port to the
intended result.
"""
import json

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.augmentation.wpe import dereverb_wpe_numpy as jwpe
from lhotse_tpu.features.io import NumpyFilesWriter as JNumpyFilesWriter
from lhotse_tpu.features.kaldi.extractors import Fbank as JFbank
from lhotse_tpu.features.kaldi.extractors import FbankConfig as JFbankConfig
from lhotse_tpu.testing import dummies as JD
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch import audio as PAudio
from lhotse_tpu_torch import cut as PCut
from lhotse_tpu_torch import supervision as PSup
from lhotse_tpu_torch.augmentation import AudioTransform, DereverbWPE
from lhotse_tpu_torch.augmentation.wpe import dereverb_wpe_numpy
from lhotse_tpu_torch.dataset import collation as pcol
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.features.io import LilcomChunkyWriter, NumpyFilesWriter
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.testing import dummies as PD
from lhotse_tpu_torch.utils import fix_random_seed

SR = 16000
DUR = 2.0
N = int(SR * DUR)

PKGS = {
    "port": dict(Recording=PAudio.Recording, CutSet=PCut.CutSet, MultiCut=PCut.MultiCut,
                 MonoCut=PCut.MonoCut, MixedCut=PCut.MixedCut,
                 SupervisionSegment=PSup.SupervisionSegment, seed=fix_random_seed),
    "jax": dict(Recording=J.Recording, CutSet=J.CutSet, MultiCut=J.MultiCut, MonoCut=J.MonoCut,
                MixedCut=J.MixedCut, SupervisionSegment=J.SupervisionSegment, seed=jfix),
}


def _both(build):
    """``build(pkg)`` for the port and for JAX, each after seeding its uuid4."""
    out = []
    for name in ("port", "jax"):
        PKGS[name]["seed"](0)
        out.append(build(PKGS[name]))
    return out


def _dict(obj):
    return json.loads(json.dumps(obj.to_dict()))


@pytest.fixture
def stereo(tmp_path):
    rng = np.random.RandomState(0)
    t = np.arange(N) / SR
    left = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    right = (0.1 * rng.randn(N)).astype(np.float32)
    path = tmp_path / "stereo.wav"
    write_wav(str(path), np.stack([left, right]), SR)
    return path, left, right


def _cut(pkg, path):
    rec = pkg["Recording"].from_file(path)
    c = rec.to_cut()
    c.supervisions = [
        pkg["SupervisionSegment"](
            id="s0", recording_id=rec.id, start=0.25, duration=1.0, channel=[0, 1], text="hi")]
    return c


def _rir_wav(tmp_path, channels, seconds=0.25):
    n = int(seconds * SR)
    rng = np.random.RandomState(7)
    decay = np.exp(-np.arange(n) / (0.02 * SR))
    data = np.stack(
        [decay * (rng.randn(n) * 0.05 + (np.arange(n) == 0)) for _ in range(channels)]
    ).astype(np.float32)
    p = tmp_path / f"rir{channels}.wav"
    write_wav(str(p), data, SR)
    return p


def _tone_mono(pkg, path):
    rec = pkg["Recording"].from_file(path, recording_id="c0")
    return pkg["MonoCut"](
        id="c0", start=0.1, duration=1.1, channel=0, recording=rec,
        supervisions=[pkg["SupervisionSegment"](
            id="c0-sup", recording_id="c0", start=0.1, duration=0.9, channel=0, text="c0")])


@pytest.fixture
def tone(tmp_path):
    t = np.arange(int(1.2 * SR)) / SR
    p = tmp_path / "c0.wav"
    write_wav(str(p), (0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32), SR)
    return p


# -- tests/test_multi_cut.py::TestMultiCutBasics ---------------------------------------------


def test_recording_to_cut_is_multi(stereo):
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]))
    assert isinstance(ours, PCut.MultiCut) and ours.num_channels == 2 and ours.channel == [0, 1]
    assert _dict(ours) == _dict(theirs)


@pytest.mark.parametrize("channel", [None, 0, 1, [1, 0]])
def test_load_audio_equals_jax(stereo, channel):
    path, left, right = stereo
    ours, theirs = _both(lambda pkg: _cut(pkg, path).load_audio(channel=channel))
    np.testing.assert_array_equal(ours, theirs)
    if channel is None:
        assert ours.shape == (2, N)
        np.testing.assert_allclose(ours[0], left, atol=1e-4)
        np.testing.assert_allclose(ours[1], right, atol=1e-4)
    elif channel == 0:
        assert ours.shape == (1, N)
        np.testing.assert_allclose(ours[0], left, atol=1e-4)


@pytest.mark.parametrize("channels", [1, [0, 1]])
def test_with_channels_equals_jax(stereo, channels):
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]).with_channels(channels))
    assert type(ours).__name__ == type(theirs).__name__
    assert isinstance(ours, PCut.MonoCut if channels == 1 else PCut.MultiCut)
    assert _dict(ours) == _dict(theirs)
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())
    if channels == 1:
        assert ours.channel == 1 and ours.load_audio().shape == (1, N)


def test_truncate_keeps_channels(stereo):
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]).truncate(offset=0.5, duration=1.0))
    assert isinstance(ours, PCut.MultiCut) and _dict(ours) == _dict(theirs)
    audio = ours.load_audio()
    assert audio.shape == (2, SR)
    np.testing.assert_array_equal(audio, theirs.load_audio())
    full = _cut(PKGS["port"], stereo[0]).load_audio()
    np.testing.assert_allclose(audio, full[:, SR // 2: SR // 2 + SR], atol=1e-6)


# -- tests/test_multi_cut.py::TestToFromMono -------------------------------------------------


def test_to_mono_splits_channels(stereo):
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]).to_mono())
    assert [_dict(c) for c in ours] == [_dict(c) for c in theirs]
    assert all(isinstance(m, PCut.MonoCut) for m in ours) and len(ours) == 2
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.load_audio(), t.load_audio())


def test_to_mono_downmix_sums_channels(stereo):
    path, left, right = stereo
    ours, theirs = _both(lambda pkg: _cut(pkg, path).to_mono(mono_downmix=True))
    assert isinstance(ours, PCut.MonoCut)
    assert [_dict(s) for s in ours.supervisions] == [_dict(s) for s in theirs.supervisions]
    assert ours.recording.sources[0].source == theirs.recording.sources[0].source
    audio = ours.load_audio()
    assert audio.shape == (1, N)
    np.testing.assert_array_equal(audio, theirs.load_audio())
    np.testing.assert_allclose(audio[0], left + right, atol=1e-3)


def test_from_mono_roundtrip(stereo):
    def build(pkg):
        cut = _cut(pkg, stereo[0])
        return cut, pkg["MultiCut"].from_mono(*cut.to_mono())

    (cut, ours), (_, theirs) = _both(build)
    assert isinstance(ours, PCut.MultiCut) and ours.channel == [0, 1]
    assert _dict(ours) == _dict(theirs)
    np.testing.assert_array_equal(ours.load_audio(), cut.load_audio())


@pytest.mark.parametrize("bad", ["shifted", "duplicate", "not mono"])
def test_from_mono_rejects(stereo, bad):
    for pkg in PKGS.values():
        cut = _cut(pkg, stereo[0])
        monos = cut.to_mono()
        args = {"shifted": (monos[0], monos[1].truncate(offset=0.5)),
                "duplicate": (monos[0], monos[0]), "not mono": (cut,)}[bad]
        with pytest.raises(AssertionError):
            pkg["MultiCut"].from_mono(*args)


# -- tests/test_multi_cut.py::TestMultiCutOps ------------------------------------------------


def test_pad_produces_mixed_with_multi_track(stereo):
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]).pad(duration=3.0))
    assert isinstance(ours, PCut.MixedCut) and ours.tracks[0].type == "MultiCut"
    assert _dict(ours) == _dict(theirs)
    audio = ours.load_audio()
    assert audio.shape == (2, int(3.0 * SR))
    np.testing.assert_array_equal(audio, theirs.load_audio())
    np.testing.assert_allclose(audio[:, N:], 0.0, atol=1e-7)
    validate(ours, read_data=True)


def test_resample(stereo):
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]).resample(8000))
    assert _dict(ours) == _dict(theirs)
    audio = ours.load_audio()
    assert audio.shape[0] == 2 and abs(audio.shape[1] - SR) <= 1
    np.testing.assert_array_equal(audio, theirs.load_audio())


def test_supervision_masks_cover_channels(stereo):
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]).supervisions_audio_mask())
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (N,)
    lo, hi = int(0.25 * SR), int(1.25 * SR)
    assert ours[lo:hi].all() and not ours[: lo - 1].any()


def test_serialization_roundtrip(stereo, tmp_path):
    cut = _cut(PKGS["port"], stereo[0])
    restored = PCut.MultiCut.from_dict(cut.to_dict())
    assert isinstance(restored, PCut.MultiCut) and restored.channel == cut.channel
    assert restored.supervisions[0].channel == [0, 1]
    np.testing.assert_array_equal(restored.load_audio(), cut.load_audio())
    # A manifest either package wrote reads in the other.
    PCut.CutSet.from_cuts([cut]).to_file(tmp_path / "ours.jsonl.gz")
    J.CutSet.from_cuts([_cut(PKGS["jax"], stereo[0])]).to_file(tmp_path / "jax.jsonl.gz")
    for name in ("ours", "jax"):
        (back,) = list(PCut.CutSet.from_file(tmp_path / f"{name}.jsonl.gz"))
        (jback,) = list(J.CutSet.from_file(tmp_path / f"{name}.jsonl.gz"))
        assert isinstance(back, PCut.MultiCut) and _dict(back) == _dict(jback) == _dict(cut)
        np.testing.assert_array_equal(back.load_audio(), cut.load_audio())


def test_perturb_volume(stereo):
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]).perturb_volume(2.0))
    assert _dict(ours) == _dict(theirs)
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())
    np.testing.assert_allclose(
        ours.load_audio(), 2.0 * _cut(PKGS["port"], stereo[0]).load_audio(), atol=1e-4)


def test_reverb_rir_with_explicit_rir(stereo, tmp_path):
    rir_path = tmp_path / "rir.wav"
    taps = np.exp(-np.arange(1600) / 200.0).astype(np.float32) * 0.2
    taps[10] = 1.0
    write_wav(str(rir_path), taps, SR)

    def build(pkg):
        return _cut(pkg, stereo[0]).reverb_rir(rir_recording=pkg["Recording"].from_file(rir_path))

    ours, theirs = _both(build)
    assert isinstance(ours, PCut.MultiCut) and ours.id.endswith("_rvb")
    assert _dict(ours) == _dict(theirs)
    audio = ours.load_audio()
    assert audio.shape == (2, N) and np.isfinite(audio).all()
    np.testing.assert_array_equal(audio, theirs.load_audio())


def test_reverb_rir_synthetic_requires_mono(stereo):
    for pkg in PKGS.values():
        with pytest.raises(AssertionError):
            _cut(pkg, stereo[0]).reverb_rir()


@pytest.mark.parametrize("merge_channels", [True, False])
def test_merge_supervisions(stereo, merge_channels):
    def build(pkg):
        cut = _cut(pkg, stereo[0])
        cut.supervisions.append(pkg["SupervisionSegment"](
            id="s1", recording_id=cut.recording_id, start=1.3, duration=0.5, channel=[0, 1],
            text="there"))
        cut.supervisions.append(pkg["SupervisionSegment"](
            id="s2", recording_id=cut.recording_id, start=1.9, duration=0.1, channel=1,
            text="again"))
        return cut.merge_supervisions(merge_channels=merge_channels)

    ours, theirs = _both(build)
    assert _dict(ours) == _dict(theirs)
    if merge_channels:
        assert [s.text for s in ours.supervisions] == ["hi there again"]


# -- tests/test_cut_augmentation_matrix.py: RIR fan-out, WPE on mono and multi cuts ----------


def test_cut_reverb_multi_channel_rir_fans_out(tone, tmp_path):
    rir = _rir_wav(tmp_path, channels=2)

    def build(pkg):
        cut = _tone_mono(pkg, tone)
        return cut.reverb_rir(
            rir_recording=pkg["Recording"].from_file(rir, recording_id="rir2"),
            rir_channels=[0, 1])

    ours, theirs = _both(build)
    assert isinstance(ours, PCut.MultiCut) and ours.channel == [0, 1]
    assert _dict(ours) == _dict(theirs)
    audio = ours.load_audio()
    assert audio.shape == (2, ours.num_samples)
    np.testing.assert_array_equal(audio, theirs.load_audio())
    assert not np.allclose(audio[0], audio[1], atol=1e-6)
    # One channel of the fan-out: the port runs the RIR on the mono source
    # and picks the row; the JAX package finds no source for the channel.
    one = ours.with_channels(1)
    np.testing.assert_array_equal(one.load_audio(), audio[1:])
    with pytest.raises(ValueError):
        theirs.with_channels(1).load_audio()


def test_multi_channel_rir_refuses_a_channel_of_a_multi_channel_recording(stereo, tmp_path):
    """A MonoCut of one channel of a stereo recording cannot fan out: the
    port refuses it; the JAX package's MultiCut reverberates both of the
    recording's channels, pairing each with one RIR channel."""
    rir = _rir_wav(tmp_path, channels=2)
    mono = _cut(PKGS["port"], stereo[0]).with_channels(1)
    with pytest.raises(ValueError, match="fans out a single-channel recording"):
        mono.reverb_rir(rir_recording=PAudio.Recording.from_file(rir), rir_channels=[0, 1])
    jmono = _cut(PKGS["jax"], stereo[0]).with_channels(1)
    jfanned = jmono.reverb_rir(rir_recording=J.Recording.from_file(rir), rir_channels=[0, 1])
    both = _cut(PKGS["jax"], stereo[0]).reverb_rir(
        rir_recording=J.Recording.from_file(rir), rir_channels=[0, 1])
    np.testing.assert_array_equal(jfanned.load_audio(), both.load_audio())


def test_mono_cut_dereverb_wpe(tone, tmp_path):
    rir = _rir_wav(tmp_path, channels=1)

    def build(pkg):
        cut = _tone_mono(pkg, tone)
        return cut.reverb_rir(
            rir_recording=pkg["Recording"].from_file(rir, recording_id="rir")).dereverb_wpe()

    ours, theirs = _both(build)
    assert _dict(ours) == _dict(theirs) and ours.id.endswith("_rvb_wpe")
    audio = ours.load_audio()
    assert audio.shape == (1, ours.num_samples) and np.isfinite(audio).all()
    np.testing.assert_array_equal(audio, theirs.load_audio())


def test_multi_cut_dereverb_wpe(tmp_path):
    n = int(0.8 * SR)
    rng = np.random.RandomState(3)
    p = tmp_path / "st.wav"
    write_wav(str(p), (0.1 * rng.randn(2, n)).astype(np.float32), SR)

    def build(pkg):
        rec = pkg["Recording"].from_file(p)
        return pkg["MultiCut"](
            id="mc", start=0.0, duration=rec.duration, channel=[0, 1], recording=rec
        ).dereverb_wpe()

    ours, theirs = _both(build)
    assert _dict(ours) == _dict(theirs)
    assert ours.recording.transforms[-1] == DereverbWPE()
    audio = ours.load_audio()
    assert audio.shape == (2, ours.num_samples) and np.isfinite(audio).all()
    np.testing.assert_array_equal(audio, theirs.load_audio())
    # to_mono() after dereverb_wpe(): WPE still sees both channels in the
    # port; the JAX package runs it on the one channel alone.
    for ch, (mono, jmono) in enumerate(zip(ours.to_mono(), theirs.to_mono())):
        np.testing.assert_array_equal(mono.load_audio(), audio[ch:ch + 1])
        np.testing.assert_array_equal(
            jmono.load_audio(), jwpe(_cut_audio(p, ch)).astype(np.float32))
        assert not np.allclose(jmono.load_audio(), audio[ch:ch + 1], atol=1e-4)


def _cut_audio(path, ch):
    return J.Recording.from_file(path).load_audio(channels=ch)


def test_host_wpe_equals_jax_bit_for_bit():
    rng = np.random.default_rng(11)
    n = int(0.6 * SR)
    t = np.arange(n) / SR
    dry = np.sin(2 * np.pi * 300 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    audio = np.stack([dry + 0.3 * rng.standard_normal(n) for _ in range(4)]).astype(np.float32)
    ours = dereverb_wpe_numpy(audio)
    assert ours.shape == audio.shape and ours.dtype == np.float32
    assert np.array_equal(ours, jwpe(audio))
    assert np.array_equal(DereverbWPE(taps=5)(audio), jwpe(audio, taps=5))
    assert np.array_equal(dereverb_wpe_numpy(audio.astype(np.float64), iterations=1),
                          jwpe(audio.astype(np.float64), iterations=1))
    # The transform reads back from a manifest of either package.
    d = J.Recording.from_dict(
        {"id": "r", "sources": [], "sampling_rate": SR, "num_samples": n, "duration": n / SR}
    ).dereverb_wpe().transforms[-1].to_dict()
    assert AudioTransform.from_dict(d) == DereverbWPE() and DereverbWPE().to_dict() == d


# -- the CutSet operations on MultiCuts ------------------------------------------------------


def test_from_manifests_and_combine_same_recording_channels(stereo):
    def build(pkg):
        rec = pkg["Recording"].from_file(stereo[0])
        cuts = pkg["CutSet"].from_manifests(recordings=J.RecordingSet.from_recordings([rec])
                                            if pkg is PKGS["jax"] else
                                            PAudio.RecordingSet.from_recordings([rec]))
        monos = pkg["CutSet"].from_cuts(m for c in cuts for m in c.to_mono())
        return cuts, monos, monos.combine_same_recording_channels()

    (cuts, monos, combined), (jcuts, jmonos, jcombined) = _both(build)
    assert [_dict(c) for c in cuts] == [_dict(c) for c in jcuts]
    assert isinstance(cuts[0], PCut.MultiCut)
    assert len(cuts.multi_cuts) == 1 and not monos.multi_cuts and not cuts.mixed_cuts
    assert [_dict(c) for c in combined] == [_dict(c) for c in jcombined]
    with pytest.raises(ValueError, match="MultiCuts"):
        cuts.combine_same_recording_channels()


def test_mixing_checks_channel_layouts(stereo):
    for pkg in PKGS.values():
        cut = _cut(pkg, stereo[0])
        with pytest.raises(AssertionError, match="different channel ids"):
            cut.mix(cut.with_channels([1, 0]))
        mixed = cut.pad(duration=3.0)
        with pytest.raises(AssertionError, match="different channel ids"):
            mixed.mix(cut.with_channels([1, 0]))
    ours, theirs = _both(lambda pkg: _cut(pkg, stereo[0]).mix(_cut(pkg, stereo[0]), snr=None))
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())


def test_dummy_multi_cut_equals_jax():
    ours = PD.dummy_multi_cut(3, channel=[0, 1, 2], with_data=True, source_per_channel=True)
    theirs = JD.dummy_multi_cut(3, channel=[0, 1, 2], with_data=True, source_per_channel=True)
    assert isinstance(ours, PCut.MultiCut)
    d, jd = ours.to_dict(), theirs.to_dict()
    for x in (d, jd):
        x["features"].pop("storage_key")
    assert d == jd
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())
    validate(ours)


def test_collate_audio_multi_channel(stereo):
    def build(pkg):
        cut = _cut(pkg, stereo[0])
        return pkg["CutSet"].from_cuts([cut, cut.truncate(duration=1.5).with_id("short")])

    ours, theirs = _both(build)
    from lhotse_tpu.dataset import collation as jcol

    for downmix in (None, True, False):
        audio, lens = pcol.collate_audio(ours, mono_downmix=downmix)
        jaudio, jlens = jcol.collate_audio(theirs, mono_downmix=downmix)
        np.testing.assert_array_equal(audio, jaudio)
        np.testing.assert_array_equal(lens, jlens)
        assert audio.shape == ((2, N) if downmix else (2, 2, N))


def test_collate_multi_channel_features(tmp_path):
    """The tracks of MixedCuts as channels, from one archive the port wrote,
    read by both packages."""
    from lhotse_tpu.dataset import collation as jcol

    cuts = PCut.CutSet.from_cuts(PD.dummy_cut(i, with_data=True, duration=1.0) for i in range(2))
    feats = cuts.compute_and_store_features(
        Fbank(FbankConfig(device="cpu")), tmp_path / "feats", storage_type=NumpyFilesWriter)
    ours = PCut.CutSet.from_cuts(
        [feats[0].mix(feats[1], snr=None), feats[1].mix(feats[0], snr=None)])
    theirs = J.CutSet.from_dicts([c.to_dict() for c in ours])
    got, want = pcol.collate_multi_channel_features(ours), jcol.collate_multi_channel_features(theirs)
    assert got.shape == (2, 2, 100, 80)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 1], feats[1].load_features())


# -- multi-channel features: stored (C, T, F), read back per channel -------------------------


def test_multi_channel_features_store_and_read_back(tmp_path, stereo):
    """The port stores one ``(C, T, F)`` matrix per cut and reads a time
    window and a channel subset of it; the JAX package's manifest for such
    a matrix counts its channels as frames, and its validation refuses it."""
    ext = Fbank(FbankConfig(device="cpu"))
    cut = _cut(PKGS["port"], stereo[0])
    for writer in (LilcomChunkyWriter, NumpyFilesWriter):
        with writer(tmp_path / f"feats_{writer.name}") as storage:
            featured = cut.compute_and_store_features(ext, storage)
        whole = featured.load_features()
        assert whole.shape == (2, featured.num_frames, 80) and featured.features.channels == [0, 1]
        per_channel = np.stack([ext.extract(a, SR) for a in cut.load_audio()])
        tol = 2.0 ** -6 if writer is LilcomChunkyWriter else 0.0
        np.testing.assert_allclose(whole, per_channel, rtol=0, atol=tol)
        validate(featured, read_data=True)
        part = featured.truncate(offset=0.5, duration=1.0)
        got = part.load_features()
        assert got.shape == (2, part.num_frames, 80)
        np.testing.assert_array_equal(got, whole[:, 50:150])
        np.testing.assert_array_equal(part.load_features(channel=1), whole[1:, 50:150])
    jcut = _cut(PKGS["jax"], stereo[0])
    with pytest.raises(AssertionError, match="num_frames is 2"):
        jcut.compute_and_store_features(
            JFbank(JFbankConfig(device="tpu")), JNumpyFilesWriter(tmp_path / "jax_feats"))


def test_extract_batch_refuses_multi_channel_items(stereo, tmp_path):
    """The JAX package's ``extract_batch`` flattens a (C, T) item into one
    row, the channels joined in time; the port refuses such an item, and
    with it ``compute_and_store_features_batch`` of a MultiCut."""
    audio = _cut(PKGS["port"], stereo[0]).load_audio()
    theirs = JFbank(JFbankConfig(device="tpu")).extract_batch([audio], SR)[0]
    assert theirs.shape == (2 * N // 160, 80)
    ext = Fbank(FbankConfig(device="cpu"))
    with pytest.raises(ValueError, match="one channel per item"):
        ext.extract_batch([audio], SR)
    cuts = PCut.CutSet.from_cuts([_cut(PKGS["port"], stereo[0])])
    with pytest.raises(ValueError, match="one channel per item"):
        cuts.compute_and_store_features_batch(ext, tmp_path / "batch")
    # One channel per item gives each channel's features.
    np.testing.assert_array_equal(ext.extract_batch(list(audio), SR), ext.extract(audio, SR))


# -- global feature statistics over multi-channel features ---------------------------------


@pytest.mark.parametrize("route", ["stored", "extractor"])
def test_global_stats_over_multi_channel_features(tmp_path, route):
    """Per-bin statistics of (C, T, F) features count every channel-frame
    as a frame: two 2-channel cuts of different lengths give (80,) means and
    stds equal to numpy's over all channel-frames, from the stored features
    and from the ``extractor=`` route."""
    ext = Fbank(FbankConfig(device="cpu"))
    cuts = PCut.CutSet.from_cuts(
        PD.dummy_multi_cut(i, with_data=True, duration=d, recording_duration=d).drop_features()
        for i, d in enumerate((1.0, 1.5)))
    if route == "stored":
        cuts = cuts.compute_and_store_features(ext, tmp_path / "feats").to_eager()
        mats = [c.load_features() for c in cuts]
        stats = cuts.compute_global_feature_stats()
    else:
        mats = [c.compute_features(ext) for c in cuts]
        stats = cuts.compute_global_feature_stats(extractor=ext)
    assert [m.shape for m in mats] == [(2, 100, 80), (2, 150, 80)]
    frames = np.concatenate([m.reshape(-1, 80) for m in mats]).astype(np.float64)
    assert stats["norm_means"].shape == stats["norm_stds"].shape == (80,)
    np.testing.assert_allclose(stats["norm_means"], frames.mean(axis=0), rtol=0, atol=1e-10)
    np.testing.assert_allclose(stats["norm_stds"], frames.std(axis=0), rtol=0, atol=1e-10)


# -- trimming single-microphone meeting cuts ------------------------------------------------


def test_trimmed_sdm_cuts_name_their_channel_as_an_int(tmp_path):
    """AMI's ``sdm`` supervisions carry ``channel=[0]`` on a one-channel
    recording. Trimmed to them, the JAX package's MonoCuts take the list;
    the port's take its element, as a MonoCut names its channel, and so go
    on through ``MultiCut.from_mono``."""
    from lhotse_tpu.recipes import ami as jami
    from lhotse_tpu_torch.recipes import ami as pami
    from test_torch_ami import _ami_corpus

    corpus = _ami_corpus(tmp_path / "ami", ["ES2002a", "ES2011a", "ES2004a"])
    trimmed = {}
    for name, prepare, CS in (("port", pami.prepare_ami, PCut.CutSet),
                              ("jax", jami.prepare_ami, J.CutSet)):
        train = prepare(corpus, output_dir=tmp_path / name, mic="sdm")["train"]
        assert {s.channel == [0] for s in train["supervisions"]} == {True}
        trimmed[name] = CS.from_manifests(**train).trim_to_supervisions(
            keep_overlapping=False).to_eager()
    n = len(trimmed["jax"])
    assert n > 0 and len(trimmed["port"]) == n
    assert {type(c) for c in trimmed["port"]} == {PCut.MonoCut}
    assert [c.channel for c in trimmed["jax"]] == [[0]] * n
    assert [c.channel for c in trimmed["port"]] == [0] * n
    merged = PCut.MultiCut.from_mono(trimmed["port"][0])
    assert merged.channel == [0]
