"""
The port's lossy-codec augmentation against the JAX package's: the
``Compress`` audio transform (lhotse_tpu_torch.augmentation.compress), the
``compress`` builders of ``Recording``, ``DataCut`` and ``MixedCut``, the
``Compress`` cut transform (lhotse_tpu_torch.dataset.cut_transforms), and
manifests that carry a ``Compress`` transform.

The round trips call the same system codec libraries as the JAX package,
so arrays are compared with ``np.array_equal`` and manifests as dicts. The
cut transform's draws (probability, then level, then ``rng.choices`` for
the codec), renamed ids and state dicts are compared draw for draw. Every
input is made inside the test from a numpy seed.
"""
import copy
import json
import random
import shutil
import types

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio import syscodecs as jsc
from lhotse_tpu.audio.wavio import write_wav as jwrite_wav
from lhotse_tpu.augmentation import AudioTransform as JAudioTransform
from lhotse_tpu.augmentation.compress import Compress as JCompress
from lhotse_tpu.dataset import cut_transforms as JT
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.augmentation import AudioTransform, Compress
from lhotse_tpu_torch.cut import CutSet, MixedCut, PaddingCut
from lhotse_tpu_torch.dataset import cut_transforms as PT
from lhotse_tpu_torch.utils import fastcopy, fix_random_seed

pytestmark = pytest.mark.skipif(
    not (jsc.mp3_available() and jsc.mp3_encode_available() and jsc.vorbis_available()
         and jsc.vorbis_encode_available() and jsc.opus_available()),
    reason="the system codec libraries (mpg123, mp3lame, vorbis, opus, ogg) are not present")

SR = 16000
CODECS = ["opus", "mp3", "vorbis"]
# The port's names the builders below take from a package, as ``J`` gives JAX's.
P = types.SimpleNamespace(Recording=Recording, CutSet=CutSet, fastcopy=fastcopy)


def _signal(seed, channels, sr, seconds=0.4):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    rows = [0.3 * np.sin(2 * np.pi * (180.0 + 130.0 * c) * t) + 0.05 * rng.standard_normal(t.size)
            for c in range(channels)]
    return np.clip(np.stack(rows), -0.99, 0.99).astype(np.float32)


# -- the audio transform ---------------------------------------------------------------


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("level", [None, 0.0, 0.5, 1.0])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sr", [16000, 44100])
def test_compress_arrays_equal_jax(codec, level, channels, sr):
    """At 44.1 kHz opus resamples to 48 kHz before encoding and decodes
    back to 44.1 kHz through ``resample_array``."""
    x = _signal(sr + channels, channels, sr)
    ours = Compress(codec=codec, compression_level=level)(x, sr)
    theirs = JCompress(codec=codec, compression_level=level)(x, sr)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == x.shape
    np.testing.assert_array_equal(ours, theirs)


def test_compress_keeps_a_1d_input_dtype_and_length():
    x = _signal(1, 1, SR)[0].astype(np.float64)
    for codec in CODECS:
        ours = Compress(codec=codec, compression_level=0.3)(x, SR)
        theirs = JCompress(codec=codec, compression_level=0.3)(x, SR)
        assert ours.dtype == np.float64 and ours.shape == (1, x.size)
        np.testing.assert_array_equal(ours, theirs)


def test_channel_subset_is_compressed_alone_as_in_jax():
    """The stereo encoders code channels jointly: compressing channel 0 alone
    is not channel 0 of the compressed pair, in either package."""
    x = _signal(3, 2, SR)
    for codec in CODECS:
        pair = Compress(codec=codec, compression_level=0.5)(x, SR)
        alone = Compress(codec=codec, compression_level=0.5)(x[:1], SR)
        np.testing.assert_array_equal(alone, JCompress(codec=codec, compression_level=0.5)(
            x[:1], SR))
        assert not np.array_equal(pair[:1], alone)


def test_gsm_without_ffmpeg_raises_as_jax(monkeypatch):
    """GSM is not in the system libraries; the JAX package's route through
    the ``ffmpeg`` binary is kept, and without ``ffmpeg`` both raise the
    same error."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    x = _signal(2, 1, 8000)
    with pytest.raises(RuntimeError) as ours:
        Compress(codec="gsm")(x, 8000)
    with pytest.raises(RuntimeError) as theirs:
        JCompress(codec="gsm")(x, 8000)
    assert str(ours.value) == str(theirs.value) and "ffmpeg" in str(ours.value)


@pytest.mark.parametrize("kwargs", [{"codec": "aac"}, {"codec": "opus", "compression_level": 1.5},
                                    {"codec": "mp3", "compression_level": -0.1}])
def test_bad_arguments_raise_as_jax(kwargs):
    with pytest.raises(ValueError) as ours:
        Compress(**kwargs)
    with pytest.raises(ValueError) as theirs:
        JCompress(**kwargs)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("codec", ["opus", "mp3", "vorbis", "gsm"])
def test_transform_dict_reads_both_ways(codec):
    theirs = JCompress(codec=codec, compression_level=0.25)
    d = theirs.to_dict()
    ours = AudioTransform.from_dict(copy.deepcopy(d))
    assert isinstance(ours, Compress) and ours.to_dict() == d
    assert JAudioTransform.from_dict(ours.to_dict()).to_dict() == d
    assert ours.reverse_timestamps(0.25, 0.5, SR) == (0.25, 0.5)


# -- the builders -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Mono WAV, a 48 kHz MP3 clip and a stereo 16 kHz WAV, written by the
    JAX package's writers."""
    root = tmp_path_factory.mktemp("compress")
    jwrite_wav(str(root / "mono.wav"), _signal(11, 1, SR, 0.8), SR)
    (root / "clip.mp3").write_bytes(jsc.mp3_encode(_signal(12, 1, 48000, 0.6), 48000))
    jwrite_wav(str(root / "stereo.wav"), _signal(13, 2, SR, 0.5), SR)
    jwrite_wav(str(root / "noise.wav"), _signal(14, 1, SR, 0.3), SR)
    return root


@pytest.mark.parametrize("name", ["mono.wav", "clip.mp3", "stereo.wav"])
@pytest.mark.parametrize("codec,level", [("opus", 0.99), ("mp3", 0.2), ("vorbis", 0.7)])
def test_recording_compress_equal_jax(files, name, codec, level):
    ours = Recording.from_file(files / name).compress(codec, level)
    theirs = J.Recording.from_file(files / name).compress(codec, level)
    assert ours.to_dict() == theirs.to_dict()
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())
    np.testing.assert_array_equal(ours.load_audio(channels=0, offset=0.1, duration=0.2),
                                  theirs.load_audio(channels=0, offset=0.1, duration=0.2))


def test_recording_compress_gsm_brackets_with_resamples(files):
    ours = Recording.from_file(files / "mono.wav").compress("gsm", 0.5)
    theirs = J.Recording.from_file(files / "mono.wav").compress("gsm", 0.5)
    assert ours.to_dict() == theirs.to_dict()
    assert [t.name if hasattr(t, "name") else type(t).__name__ for t in ours.transforms] == [
        "Resample", "Compress", "Resample"]
    for bad in [("aac", 0.5), ("opus", 2.0)]:
        with pytest.raises(ValueError) as o:
            Recording.from_file(files / "mono.wav").compress(*bad)
        with pytest.raises(ValueError) as t:
            J.Recording.from_file(files / "mono.wav").compress(*bad)
        assert str(o.value) == str(t.value)


@pytest.mark.parametrize("custom", [False, True])
def test_cut_compress_with_custom_fields_equal_jax(files, custom):
    def build(pkg):
        cut = pkg.Recording.from_file(files / "mono.wav").to_cut()
        cut.custom = {"target_recording": pkg.Recording.from_file(files / "clip.mp3"),
                      "note": "keep"}
        return cut.compress("vorbis", 0.4, compress_custom_fields=custom)

    ours, theirs = build(P), build(J)
    assert ours.to_dict() == theirs.to_dict()
    assert (ours.custom["target_recording"].transforms is not None) == custom
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())
    np.testing.assert_array_equal(ours.load_target_recording(), theirs.load_target_recording())


def test_mixed_cut_compress_equal_jax(files):
    def build(pkg):
        cut = pkg.Recording.from_file(files / "mono.wav").to_cut()
        noise = pkg.Recording.from_file(files / "noise.wav").to_cut()
        return cut.mix(noise, offset_other_by=0.2, snr=10).compress("opus", 0.6)

    # ``mix`` names the new cut with ``uuid4``, which each package seeds.
    fix_random_seed(0)
    ours = build(P)
    jfix(0)
    theirs = build(J)
    assert isinstance(ours, MixedCut)
    assert ours.to_dict() == theirs.to_dict()
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())


def test_mixed_cut_with_padding_compresses(files):
    """The port's ``PaddingCut`` passes ``compress`` through; the JAX
    package's has no ``compress``, so a padded ``MixedCut`` raises there."""
    ours = Recording.from_file(files / "mono.wav").to_cut().pad(duration=1.2)
    theirs = J.Recording.from_file(files / "mono.wav").to_cut().pad(duration=1.2)
    assert any(isinstance(t.cut, PaddingCut) for t in ours.tracks)
    with pytest.raises(AttributeError, match="compress"):
        theirs.compress("mp3", 0.5)
    compressed = ours.compress("mp3", 0.5)
    audio = compressed.load_audio()
    assert audio.shape == (1, compressed.num_samples)
    # The speech track is the JAX package's compressed track; the padding
    # stays silence.
    (jtrack,) = [t.cut for t in theirs.tracks if not isinstance(t.cut, J.PaddingCut)]
    np.testing.assert_array_equal(audio[:, :jtrack.num_samples],
                                  jtrack.compress("mp3", 0.5).load_audio())
    assert not audio[:, jtrack.num_samples:].any()


def test_jax_manifest_with_compress_loads(files, tmp_path):
    """A cut manifest the JAX package wrote with a ``Compress`` transform
    reads in the port, gives the same dict and the same audio."""
    cuts = [J.Recording.from_file(files / "mono.wav").to_cut().compress("opus", 0.5),
            J.Recording.from_file(files / "clip.mp3").to_cut().compress("mp3", 0.1)]
    J.CutSet.from_cuts(cuts).to_file(tmp_path / "cuts.jsonl")
    ours = list(CutSet.from_jsonl_lazy(tmp_path / "cuts.jsonl"))
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in cuts]
    for o, t in zip(ours, cuts):
        np.testing.assert_array_equal(o.load_audio(), t.load_audio())
    with open(tmp_path / "cuts.jsonl") as f:
        assert json.loads(f.readline())["recording"]["transforms"][0]["name"] == "Compress"


# -- the cut transform --------------------------------------------------------------------


@pytest.fixture(scope="module")
def fifty(files):
    """Fifty cuts over the mono WAV, as both packages' eager CutSets."""
    def build(pkg):
        rec = pkg.Recording.from_file(files / "mono.wav")
        return pkg.CutSet.from_cuts(
            pkg.fastcopy(rec.to_cut(), id=f"cut{i:02d}") for i in range(50))

    return build(P), build(J)


TRANSFORMS = {
    "range": dict(codecs=["opus", "mp3", "vorbis"], compression_level=(0.1, 0.9), p=0.5, seed=7),
    "weighted": dict(codecs=["mp3", "vorbis"], compression_level=0.4, codec_weights=[3.0, 1.0],
                     p=0.8, seed=11),
    "preserve_id": dict(codecs=["opus", "gsm"], compression_level=(0.0, 1.0), p=1.0, seed=3,
                        preserve_id=True),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_cut_transform_draws_equal_jax(fifty, name):
    ours_in, theirs_in = fifty
    ours = list(PT.Compress(**TRANSFORMS[name])(ours_in))
    theirs = list(JT.Compress(**TRANSFORMS[name])(theirs_in))
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    changed = [c for c in ours if c.recording.transforms]
    assert 0 < len(changed) <= 50
    if not TRANSFORMS[name].get("preserve_id"):
        assert all(c.id.count("_") == 2 for c in changed)


def test_cut_transform_audio_equal_jax(fifty):
    ours = list(PT.Compress(**TRANSFORMS["range"])(fifty[0]))
    theirs = list(JT.Compress(**TRANSFORMS["range"])(fifty[1]))
    codecs = {}
    for o, t in zip(ours, theirs):
        if o.recording.transforms and o.id.split("_")[1] not in codecs:
            codecs[o.id.split("_")[1]] = (o, t)
    assert sorted(codecs) == ["mp3", "opus", "vorbis"]
    for o, t in codecs.values():
        np.testing.assert_array_equal(o.load_audio(), t.load_audio())


def test_cut_transform_state_dict_resumes_across_packages(fifty):
    ours_in, theirs_in = fifty
    first, rest = CutSet.from_cuts(list(ours_in)[:20]), CutSet.from_cuts(list(ours_in)[20:])
    whole = [c.id for c in PT.Compress(**TRANSFORMS["range"])(ours_in)]
    ours = PT.Compress(**TRANSFORMS["range"])
    head = [c.id for c in ours(first)]
    state = copy.deepcopy(ours.state_dict())
    # The port's state resumes in a fresh port transform and in JAX's.
    resumed = PT.Compress(**{**TRANSFORMS["range"], "seed": 0})
    resumed.load_state_dict(copy.deepcopy(state))
    assert head + [c.id for c in resumed(rest)] == whole
    jresumed = JT.Compress(**{**TRANSFORMS["range"], "seed": 0})
    jresumed.load_state_dict(copy.deepcopy(state))
    jrest = J.CutSet.from_cuts(list(theirs_in)[20:])
    assert head + [c.id for c in jresumed(jrest)] == whole
    # And JAX's state resumes in the port.
    jt = JT.Compress(**TRANSFORMS["range"])
    jt(J.CutSet.from_cuts(list(theirs_in)[:20]))
    back = PT.Compress(**{**TRANSFORMS["range"], "seed": 0})
    back.load_state_dict(copy.deepcopy(jt.state_dict()))
    assert [c.id for c in back(rest)] == whole[20:]


def test_cut_transform_checks_as_jax():
    for kwargs in [dict(codecs=["mp3", "mp3"]), dict(codecs=["mp3"], compression_level=(0.5, 0.2)),
                   dict(codecs=["mp3"], p=1.5), dict(codecs=["mp3", "opus"], codec_weights=[1.0])]:
        with pytest.raises(AssertionError):
            PT.Compress(**kwargs)
        with pytest.raises(AssertionError):
            JT.Compress(**kwargs)
    with pytest.raises(ValueError, match="not both"):
        PT.Compress(codecs=["mp3"], rng=random.Random(0))
    assert isinstance(PT.Compress(codecs=["mp3"], seed=None, rng=random.Random(0)).rng,
                      random.Random)


@pytest.mark.parametrize("seed", [None, "randomized"])
def test_global_seeds_agree_after_fix_random_seed(seed):
    """``fix_random_seed`` in each package, then the same seed that reads the
    global random state (outside a worker), gives the same draws
    (``resolve_seed``)."""
    fix_random_seed(5)
    ours = PT.Compress(codecs=CODECS, p=0.5, seed=seed)
    jfix(5)
    theirs = JT.Compress(codecs=CODECS, p=0.5, seed=seed)
    assert [ours.rng.random() for _ in range(5)] == [theirs.rng.random() for _ in range(5)]

