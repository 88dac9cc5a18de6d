"""
The port's signal effects (lhotse_tpu_torch.augmentation: ``Clipping``,
``LoudnessNormalization``/``normalize_loudness``, ``Narrowband`` with the
mu-law and lpc10 codecs), their builders on ``Recording``, ``MonoCut``,
``MixedCut``, ``PaddingCut`` and ``CutSet``, the random cut transforms
``ClippingTransform`` and ``LowpassUsingResampling``, and the bounded
resampler caches, against the JAX package on the same seeded numpy inputs.

Both packages run the same numpy, scipy and ``dsp`` C code here, so audio
is compared with ``np.array_equal`` and manifests with ``to_dict()``
equality. Three places differ by design: the port's ``Narrowband`` brings
each channel of a multi-channel input back to its own length (the JAX
package resizes the whole result to one row), the port's resampler caches
keep a few entries where the JAX package's keep every ratio, and the
port's ``PaddingCut`` takes ``clip_amplitude`` (the JAX package's lacks
it, so clipping a concatenated cut raises there).
"""
import copy
import random

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu import augmentation as JA
from lhotse_tpu.audio.wavio import write_wav as jwrite_wav
from lhotse_tpu.augmentation import loudness as jloud
from lhotse_tpu.augmentation import narrowband as jnb
from lhotse_tpu.augmentation import resample as jres
from lhotse_tpu.cut import PaddingCut as JPaddingCut
from lhotse_tpu.dataset import cut_transforms as JT
from lhotse_tpu.utils import fastcopy as jfastcopy
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch import augmentation as PA
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.augmentation import loudness as ploud
from lhotse_tpu_torch.augmentation import narrowband as pnb
from lhotse_tpu_torch.augmentation import resample as pres
from lhotse_tpu_torch.cut import CutSet, MixedCut, MonoCut, PaddingCut
from lhotse_tpu_torch.dataset import cut_transforms as PT
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import fastcopy, fix_random_seed

SR = 16000


def _signal(seed, shape, amp=0.3):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / SR
    x = amp * np.sin(2 * np.pi * rng.uniform(90, 400) * t) + 0.05 * rng.standard_normal(shape)
    return x.astype(np.float32)


def _both(build):
    """``build(pkg)`` for the port and for JAX, each after seeding its uuid4."""
    fix_random_seed(0)
    ours = build("port")
    jfix(0)
    theirs = build("jax")
    return ours, theirs


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """A 1.3 s mono WAV, a 2-channel WAV of 16001 samples and a 0.9 s
    second mono WAV."""
    root = tmp_path_factory.mktemp("signal_effects")
    jwrite_wav(str(root / "mono.wav"), _signal(1, (int(1.3 * SR),))[None], SR)
    jwrite_wav(str(root / "stereo.wav"), _signal(2, (2, 16001)), SR)
    jwrite_wav(str(root / "other.wav"), _signal(3, (int(0.9 * SR),), amp=0.5)[None], SR)
    return root


def _recording(pkg, path, rid=None):
    cls = Recording if pkg == "port" else J.Recording
    return cls.from_file(path, recording_id=rid)


def _cut(pkg, wavs, name="mono", start=0.1):
    """A MonoCut with a nonzero start and one supervision, as
    tests/test_cut_augmentation_matrix.py builds them."""
    rec = _recording(pkg, wavs / f"{name}.wav", rid=name)
    mono, sup = (MonoCut, SupervisionSegment) if pkg == "port" else (J.MonoCut, J.SupervisionSegment)
    dur = round(rec.duration - start, 4)
    return mono(id=name, start=start, duration=dur, channel=0, recording=rec, supervisions=[
        sup(id=f"{name}-sup", recording_id=name, start=0.1, duration=round(dur - 0.2, 3),
            channel=0, text=name, speaker="A")])


# -- the transforms on arrays ---------------------------------------------------------------


@pytest.mark.parametrize("hard,gain_db,normalize", [
    (True, 0.0, True), (True, 12.0, True), (False, 6.0, True), (False, -6.0, True),
    (True, 3.0, False), (False, 0.05, False)])
@pytest.mark.parametrize("channels", [1, 2])
def test_clipping_equals_jax(hard, gain_db, normalize, channels):
    x = _signal(10 + channels, (channels, 12000), amp=0.8)
    ours = PA.Clipping(hard, gain_db, normalize)(x, SR)
    theirs = JA.Clipping(hard, gain_db, normalize)(x, SR)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_clipping_passes_silence_and_inverts_timestamps():
    """tests/test_augmentation_transforms.py::TestClipping's edge cases."""
    for x in (np.zeros((1, 1000), np.float32), np.full((1, 1000), 1e-6, np.float32)):
        ours = PA.Clipping(hard=True, gain_db=20.0)(x, SR)
        assert np.array_equal(ours, x) and np.array_equal(ours, JA.Clipping(True, 20.0)(x, SR))
    assert PA.Clipping().reverse_timestamps(1.25, 2.0, SR) == (1.25, 2.0)
    x = _signal(4, (1, 8000), amp=0.8)
    y = PA.Clipping(hard=True, gain_db=12.0)(x, SR)  # peaks flattened to the rescaled ceiling
    assert np.abs(y).max() == pytest.approx(np.abs(x).max() / 10 ** (12.0 / 20.0), rel=1e-4)


@pytest.mark.parametrize("seconds", [0.03, 0.3, 1.7])
@pytest.mark.parametrize("channels", [1, 2, 5])
def test_measure_loudness_equals_jax(seconds, channels):
    x = _signal(20 + channels, (channels, int(seconds * SR))).astype(np.float64)
    for block in (0.4, 0.2):
        assert ploud.measure_loudness(x, SR, block) == jloud.measure_loudness(x, SR, block)


@pytest.mark.parametrize("target", [-30.0, -23.0, -15.0])
@pytest.mark.parametrize("shape", [(1, 16000), (2, 24000), (1, 500)])
def test_normalize_loudness_equals_jax(target, shape):
    x = _signal(30, shape)
    ours = PA.LoudnessNormalization(target)(x, SR)
    theirs = JA.LoudnessNormalization(target)(x, SR)
    assert ours.dtype == np.float32 and np.array_equal(ours, theirs)
    assert np.array_equal(ploud.normalize_loudness(x, target, SR), jloud.normalize_loudness(x, target, SR))
    if shape[1] >= SR:
        assert abs(ploud.measure_loudness(ours, SR) - target) < 1.0


def test_normalize_loudness_leaves_silence():
    x = np.zeros((1, SR), np.float32)
    assert np.array_equal(PA.LoudnessNormalization(-20.0)(x, SR), x)
    assert np.array_equal(JA.LoudnessNormalization(-20.0)(x, SR), x)


def test_mulaw_codec_equals_jax():
    x = _signal(40, (2, 9000), amp=1.4)  # clipped at +-1 by the codec
    ours, theirs = pnb.MuLawCodec()(x), jnb.MuLawCodec()(x)
    assert ours.dtype == np.float32 and np.array_equal(ours, theirs)
    assert len(np.unique(ours)) <= 256


@pytest.mark.parametrize("length", [16000, 16001, 12345, 7999])
@pytest.mark.parametrize("restore", [True, False])
def test_narrowband_mono_equals_jax(length, restore):
    x = _signal(50, (1, length))
    ours = PA.Narrowband("mulaw", SR, restore)(x, SR)
    theirs = JA.Narrowband("mulaw", SR, restore)(x, SR)
    assert ours.shape == theirs.shape and np.array_equal(ours, theirs)
    if restore:
        assert ours.shape == (1, length)


def test_narrowband_keeps_each_channels_length():
    """A (2, 16001) input: 16001 → 8001 → 16002 samples per channel over the
    8 kHz round trip. The JAX package resizes the whole result to
    ``(1, samples.size)`` = (1, 32002) (ROADMAP C1); the port gives (2,
    16001), each channel equal to JAX run on that channel alone. An even
    length keeps its size and equals JAX as a whole."""
    x = _signal(60, (2, 16001))
    theirs = JA.Narrowband("mulaw", SR, True)(x, SR)
    ours = PA.Narrowband("mulaw", SR, True)(x, SR)
    assert theirs.shape == (1, 32002)
    assert ours.shape == (2, 16001)
    for ch in range(2):
        assert np.array_equal(ours[ch:ch + 1], JA.Narrowband("mulaw", SR, True)(x[ch:ch + 1], SR))
    even = _signal(61, (2, 16000))
    assert np.array_equal(PA.Narrowband("mulaw", SR, True)(even, SR),
                          JA.Narrowband("mulaw", SR, True)(even, SR))


def test_narrowband_codecs_refuse_as_jax():
    with pytest.raises(ValueError, match="unsupported codec"):
        PA.Narrowband("gsm", SR, True)
    try:
        jnb.Lpc10Codec()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="libspandsp"):
            PA.Narrowband("lpc10", SR, True)
    else:  # SpanDSP is installed: both codecs run it
        x = _signal(62, (1, 16000))
        assert np.array_equal(PA.Narrowband("lpc10", SR, True)(x, SR),
                              JA.Narrowband("lpc10", SR, True)(x, SR))


@pytest.mark.parametrize("name,kwargs", [
    ("Clipping", {"hard": True, "gain_db": 3.0, "normalize": False}),
    ("LoudnessNormalization", {"target": -21.0}),
    ("Narrowband", {"codec": "mulaw", "source_sampling_rate": SR, "restore_orig_sr": True})])
def test_transform_dicts_read_both_ways(name, kwargs):
    theirs = getattr(JA, name)(**kwargs)
    ours = PA.AudioTransform.from_dict(theirs.to_dict())
    assert type(ours) is getattr(PA, name) and ours.to_dict() == theirs.to_dict()
    assert JA.AudioTransform.from_dict(ours.to_dict()).to_dict() == theirs.to_dict()
    x = _signal(70, (1, 8000))
    assert np.array_equal(ours(x, SR), theirs(x, SR))


# -- the builders ---------------------------------------------------------------------------

_RECORDING_OPS = {
    "narrowband": lambda r: r.narrowband("mulaw"),
    "narrowband_8k": lambda r: r.narrowband("mulaw", restore_orig_sr=False, affix_id=False),
    "normalize_loudness": lambda r: r.normalize_loudness(-18.0, affix_id=True),
    "clip_hard": lambda r: r.clip_amplitude(hard=True, gain_db=6.0, oversampling=None),
    "clip_oversampled": lambda r: r.clip_amplitude(gain_db=9.0, affix_id=True),
    "speed_then_narrowband": lambda r: r.perturb_speed(1.1).narrowband("mulaw"),
}


@pytest.mark.parametrize("op", sorted(_RECORDING_OPS))
def test_recording_builders_equal_jax(wavs, op):
    ours, theirs = (_RECORDING_OPS[op](_recording(pkg, wavs / "mono.wav")) for pkg in ("port", "jax"))
    assert ours.to_dict() == theirs.to_dict()
    assert Recording.from_dict(theirs.to_dict()).to_dict() == theirs.to_dict()
    audio = ours.load_audio()
    assert audio.shape == (1, ours.num_samples)
    assert np.array_equal(audio, theirs.load_audio())
    assert np.array_equal(ours.load_audio(offset=0.2, duration=0.5),
                          theirs.load_audio(offset=0.2, duration=0.5))


def test_multichannel_recording_narrowband_keeps_shape(wavs):
    """The 2-channel, 16001-sample WAV through ``narrowband``: the port
    loads (2, 16001), each channel equal to the JAX package's load of that
    channel alone (the JAX package's load of both channels at once has
    the wrong shape)."""
    ours = _recording("port", wavs / "stereo.wav").narrowband("mulaw")
    theirs = _recording("jax", wavs / "stereo.wav").narrowband("mulaw")
    assert ours.to_dict() == theirs.to_dict()
    audio = ours.load_audio()
    assert audio.shape == (2, 16001)
    for ch in range(2):
        assert np.array_equal(audio[ch:ch + 1], theirs.load_audio(channels=ch))
        assert np.array_equal(ours.load_audio(channels=ch), theirs.load_audio(channels=ch))


_CUT_OPS = {
    "narrowband": lambda c: c.narrowband("mulaw"),
    "narrowband_keep_id": lambda c: c.narrowband("mulaw", affix_id=False),
    "normalize_loudness": lambda c: c.normalize_loudness(-15.0),
    "normalize_loudness_affixed": lambda c: c.normalize_loudness(-15.0, affix_id=True),
    "clip_amplitude": lambda c: c.clip_amplitude(hard=False, gain_db=8.0),
    "clip_amplitude_hard": lambda c: c.clip_amplitude(hard=True, gain_db=4.0, oversampling=None,
                                                      affix_id=False),
    "quiet_then_loud": lambda c: c.perturb_volume(0.05).normalize_loudness(-15.0),
}


@pytest.mark.parametrize("op", sorted(_CUT_OPS))
def test_cut_builders_equal_jax(wavs, op):
    ours, theirs = (_CUT_OPS[op](_cut(pkg, wavs)) for pkg in ("port", "jax"))
    assert ours.to_dict() == theirs.to_dict()
    audio = ours.load_audio()
    assert audio.shape == (1, ours.num_samples) and np.array_equal(audio, theirs.load_audio())
    assert [s.id for s in ours.supervisions] == [s.id for s in theirs.supervisions]
    if op == "quiet_then_loud":  # tests/test_cut_augmentation_matrix.py::test_cut_normalize_loudness
        quiet = _cut("port", wavs).perturb_volume(0.05).load_audio()
        assert np.sqrt(np.mean(audio ** 2)) > np.sqrt(np.mean(quiet ** 2))


@pytest.mark.parametrize("op", ["narrowband", "normalize_loudness", "clip_amplitude"])
def test_cut_with_features_as_jax(wavs, op):
    """A cut with a features manifest: narrowband and loudness detach the
    features (and, as in the JAX package, drop them from the source cut
    too); clipping keeps them and warns."""
    from lhotse_tpu.features import Features as JFeatures
    from lhotse_tpu_torch.features import Features

    states = []
    for pkg, features in (("port", Features), ("jax", JFeatures)):
        cut = _cut(pkg, wavs)
        cut.features = features(
            type="fbank", num_frames=130, num_features=80, frame_shift=0.01, sampling_rate=SR,
            start=0.0, duration=1.3, storage_type="lilcom_chunky", storage_path="x",
            storage_key="k")
        out = _CUT_OPS[op](cut)
        states.append((out.to_dict(), cut.has_features))
    assert states[0] == states[1]
    assert states[0][1] == (op == "clip_amplitude")


def _mixed(pkg, wavs):
    a, b = _cut(pkg, wavs, "mono", 0.0), _cut(pkg, wavs, "other", 0.0)
    return a.mix(b, offset_other_by=0.4, snr=10.0)


@pytest.mark.parametrize("op", [
    "clip", "clip_hard", "loudness_mix_first", "loudness_per_track"])
def test_mixed_cut_builders_equal_jax(wavs, op):
    build = {
        "clip": lambda m: m.clip_amplitude(gain_db=6.0),
        "clip_hard": lambda m: m.clip_amplitude(hard=True, oversampling=None, affix_id=False),
        "loudness_mix_first": lambda m: m.normalize_loudness(-15.0),
        "loudness_per_track": lambda m: m.normalize_loudness(-15.0, mix_first=False, affix_id=True),
    }[op]
    ours, theirs = _both(lambda pkg: build(_mixed(pkg, wavs)))
    assert isinstance(ours, MixedCut)
    assert ours.to_dict() == theirs.to_dict()
    audio = ours.load_audio()
    assert audio.shape == (1, ours.num_samples) and np.isfinite(audio).all()
    assert np.array_equal(audio, theirs.load_audio())
    assert np.array_equal(MixedCut.from_dict(ours.to_dict()).load_audio(), audio)


def test_padding_cut_loudness_is_a_passthrough():
    ours = PaddingCut(id="pad", duration=1.0, sampling_rate=SR, feat_value=-23.0,
                      num_samples=SR).normalize_loudness(-20, affix_id=True)
    theirs = JPaddingCut(id="pad", duration=1.0, sampling_rate=SR, feat_value=-23.0,
                         num_samples=SR).normalize_loudness(-20, affix_id=True)
    assert isinstance(ours, PaddingCut) and ours.to_dict() == theirs.to_dict()
    assert np.array_equal(ours.load_audio(), theirs.load_audio())


def test_clipping_a_concatenated_cut_as_jax_clips_each_track(wavs):
    """``CutConcatenate`` joins cuts with a ``PaddingCut`` gap. The JAX
    package's PaddingCut has no ``clip_amplitude``, so clipping the joined
    cut raises there (ROADMAP C1); the port clips every track of speech and
    renames the gap, and its audio equals the JAX package's mix of the same
    tracks clipped one by one."""
    def joined(pkg):
        a, b = _cut(pkg, wavs, "mono", 0.0), _cut(pkg, wavs, "other", 0.0)
        return a.pad(a.duration + 0.5).append(b)

    ours, theirs = _both(joined)
    with pytest.raises(AttributeError, match="clip_amplitude"):
        theirs.clip_amplitude(gain_db=6.0)
    clipped = ours.clip_amplitude(gain_db=6.0)
    assert [type(t.cut).__name__ for t in clipped.tracks] == ["MonoCut", "PaddingCut", "MonoCut"]
    assert all(t.cut.id.endswith("_cl6.0") for t in clipped.tracks)
    by_hand = J.MixedCut(id=theirs.id, tracks=[
        t if isinstance(t.cut, JPaddingCut) else jfastcopy(t, cut=t.cut.clip_amplitude(gain_db=6.0))
        for t in theirs.tracks])
    assert np.array_equal(clipped.load_audio(), by_hand.load_audio())
    assert PaddingCut(id="p", duration=1.0, sampling_rate=SR, feat_value=-23.0, num_samples=SR
                      ).clip_amplitude(gain_db=3.0, affix_id=False).id == "p"


@pytest.mark.parametrize("op,kwargs", [
    ("narrowband", {"codec": "mulaw"}), ("normalize_loudness", {"target": -19.0}),
    ("normalize_loudness", {"target": -19.0, "affix_id": False})])
def test_cutset_builders_equal_jax(wavs, op, kwargs):
    """Lazy over a CutSet, one transform per cut (the JAX package's
    tests/test_cut_augmentation_matrix.py::test_cut_set_ops_dont_duplicate_transforms)."""
    def build(pkg):
        cs = (CutSet if pkg == "port" else J.CutSet).from_cuts(
            [_cut(pkg, wavs, name, 0.0) for name in ("mono", "other")])
        return getattr(cs, op)(**kwargs)

    ours, theirs = _both(build)
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    for c, t in zip(ours, theirs):
        assert len(c.recording.transforms) == 1
        assert np.array_equal(c.load_audio(), t.load_audio())


# -- the cut transforms ---------------------------------------------------------------------


def _cutset(pkg, wavs):
    cs = CutSet if pkg == "port" else J.CutSet
    return cs.from_cuts([
        _cut(pkg, wavs, name, start).with_id(f"{name}-{i}")
        for i, (name, start) in enumerate([("mono", 0.0), ("other", 0.1), ("mono", 0.2),
                                            ("other", 0.0), ("mono", 0.3), ("other", 0.2)])])


@pytest.mark.parametrize("kwargs", [
    {"gain_db": (0.0, 12.0), "p": 0.5, "seed": 3},
    {"gain_db": 6.0, "p": 1.0, "p_hard": 0.0, "seed": 4, "oversampling": None},
    {"gain_db": (2.0, 4.0), "p": 0.7, "normalize": False, "preserve_id": True, "seed": 5}])
def test_clipping_transform_equals_jax(wavs, kwargs):
    tfs = (PT.ClippingTransform(**kwargs), JT.ClippingTransform(**copy.deepcopy(kwargs)))
    ours, theirs = (tf(_cutset(pkg, wavs)) for tf, pkg in zip(tfs, ("port", "jax")))
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    assert tfs[0].state_dict() == tfs[1].state_dict()
    for c, t in zip(list(ours)[:2], list(theirs)[:2]):
        assert np.array_equal(c.load_audio(), t.load_audio())
    # A state saved by one package continues in the other.
    for src, dst, pkg in ((tfs[1], PT.ClippingTransform(**kwargs), "port"),
                          (tfs[0], JT.ClippingTransform(**copy.deepcopy(kwargs)), "jax")):
        dst.load_state_dict(copy.deepcopy(src.state_dict()))
        again = dst(_cutset(pkg, wavs))
        reference = src(_cutset("jax" if pkg == "port" else "port", wavs))
        assert [c.to_dict() for c in again] == [c.to_dict() for c in reference]


def test_clipping_transform_validates_as_jax():
    for kwargs in ({"gain_db": (3.0, 1.0)}, {"gain_db": 1.0, "p": 1.5}):
        with pytest.raises(AssertionError):
            PT.ClippingTransform(**kwargs)
        with pytest.raises(AssertionError):
            JT.ClippingTransform(**kwargs)
    with pytest.raises(ValueError, match="Either rng or seed"):
        PT.ClippingTransform(gain_db=1.0, rng=random.Random(0))


@pytest.mark.parametrize("kwargs", [
    {"p": 0.5, "frequencies_interval": (4000, 4001), "seed": 11},
    {"p": 1.0, "frequencies_interval": (6000, 6001), "seed": 12},
    {"p": 1.0, "frequencies_interval": (5000, 5001), "preserve_id": True, "seed": 13}])
def test_lowpass_equals_jax(wavs, kwargs):
    """Intervals one hertz wide fix the integer cutoff at 4, 6 or 5 kHz, so
    16 kHz → 2·cutoff is a ratio with small reduced terms and each kernel
    builds in milliseconds; a cutoff such as 3987 Hz takes seconds and
    over 100 MB per kernel, so the default interval runs on the card."""
    tfs = (PT.LowpassUsingResampling(**kwargs), JT.LowpassUsingResampling(**kwargs))
    ours, theirs = (tf(_cutset(pkg, wavs)) for tf, pkg in zip(tfs, ("port", "jax")))
    assert [c.id for c in ours] == [c.id for c in theirs]
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    assert tfs[0].state_dict() == tfs[1].state_dict()
    low = [(c, t) for c, t in zip(ours, theirs) if "_lowpassed" in c.id or kwargs.get("preserve_id")]
    for c, t in low[:2]:
        audio = c.load_audio()
        assert audio.shape == (1, c.num_samples) and np.array_equal(audio, t.load_audio())
    resumed = PT.LowpassUsingResampling(**kwargs)
    resumed.load_state_dict(copy.deepcopy(JT.LowpassUsingResampling(**kwargs).state_dict()))
    assert [c.id for c in resumed(_cutset("port", wavs))] == [c.id for c in theirs]


def test_lowpass_refuses_a_cutoff_above_nyquist(wavs):
    for tf in (PT.LowpassUsingResampling(p=1.0, frequencies_interval=(3500, 9000)),
               JT.LowpassUsingResampling(p=1.0, frequencies_interval=(3500, 9000))):
        with pytest.raises(ValueError, match="greater than"):
            tf(_cutset("port" if tf.__module__.startswith("lhotse_tpu_torch") else "jax", wavs))


# -- the bounded resampler caches -----------------------------------------------------------


def test_resampler_caches_are_bounded_and_exact():
    """20 distinct ratios, 16 kHz → k kHz (small reduced terms, each kernel
    built in milliseconds): each cache keeps at most ``CACHE_SIZE``
    entries, and every output stays equal to the JAX package's unbounded
    resampler. A ratio used again after eviction gives the same result."""
    pres._KERNEL_CACHE.clear()
    pres._RESAMPLERS.clear()
    x = _signal(80, (2, 4000))
    rates = [k * 1000 for k in range(1, 22) if k != 16][:20]
    first = {}
    for rate in rates:
        ours = pres.get_or_create_resampler(SR, rate)(x)
        assert np.array_equal(ours, jres.get_or_create_resampler(SR, rate)(x))
        assert np.array_equal(pres.resample_array(x, SR, rate), jres.resample_array(x, SR, rate))
        assert len(pres._KERNEL_CACHE) <= pres.CACHE_SIZE
        assert len(pres._RESAMPLERS) <= pres.CACHE_SIZE
        first[rate] = ours
    assert len(pres._KERNEL_CACHE) == pres.CACHE_SIZE == len(pres._RESAMPLERS)
    assert (SR, rates[0]) not in pres._RESAMPLERS  # evicted, least recently used
    assert np.array_equal(pres.get_or_create_resampler(SR, rates[0])(x), first[rates[0]])
    assert list(pres._RESAMPLERS)[-1] == (SR, rates[0])


_C1_OPS = {
    "narrowband": lambda c: c.narrowband("mulaw"),
    "dereverb_wpe": lambda c: c.dereverb_wpe(),
}
_C1_CUTS = {
    "padded": lambda pkg, wavs: _cut(pkg, wavs, "mono", 0.0).pad(duration=1.5),
    "mixed": _mixed,
}


@pytest.mark.parametrize("kind", sorted(_C1_CUTS))
@pytest.mark.parametrize("op", sorted(_C1_OPS))
def test_effects_on_padded_and_mixed_cuts(wavs, op, kind):
    """``narrowband`` and ``dereverb_wpe`` on a padded cut and on a cut
    mixed with noise (ROADMAP C1). The JAX package's ``MixedCut`` and
    ``PaddingCut`` have neither, so a set holding such a cut raises
    ``AttributeError`` there when it is iterated. The port applies the
    effect to every track of speech, passes the padding through with its
    id affixed, and its audio equals the mix of the tracks with the effect
    applied one by one."""
    apply = _C1_OPS[op]
    ours, theirs = _both(lambda pkg: _C1_CUTS[kind](pkg, wavs))
    with pytest.raises(AttributeError, match=op):
        list(apply(J.CutSet.from_cuts([theirs])))
    (changed,) = list(apply(CutSet.from_cuts([ours])))
    suffix = "_nb_mulaw" if op == "narrowband" else "_wpe"
    assert isinstance(changed, MixedCut) and changed.id == ours.id + suffix
    assert [type(t.cut) for t in changed.tracks] == [type(t.cut) for t in ours.tracks]
    assert all(t.cut.id == o.cut.id + suffix for t, o in zip(changed.tracks, ours.tracks))
    by_hand = MixedCut(id=ours.id, tracks=[
        t if isinstance(t.cut, PaddingCut) else fastcopy(t, cut=apply(t.cut)) for t in ours.tracks])
    audio = changed.load_audio()
    assert audio.shape == (1, ours.num_samples) and np.isfinite(audio).all()
    assert np.array_equal(audio, by_hand.load_audio())
    assert not np.array_equal(audio, ours.load_audio())
    if op == "narrowband":
        # The codec is the same numpy code in both packages: the JAX package's
        # tracks, changed one by one, mix to the same audio.
        jax_by_hand = J.MixedCut(id=theirs.id, tracks=[
            t if isinstance(t.cut, JPaddingCut) else jfastcopy(t, cut=apply(t.cut))
            for t in theirs.tracks])
        assert np.array_equal(audio, jax_by_hand.load_audio())


def test_padding_cut_effects_are_passthroughs():
    pad = PaddingCut(id="pad", duration=1.0, sampling_rate=SR, feat_value=-23.0, num_samples=SR)
    assert pad.narrowband("lpc10").id == "pad_nb_lpc10"
    assert pad.narrowband("mulaw", affix_id=False).id == "pad"
    assert pad.dereverb_wpe().id == "pad_wpe"
    assert pad.dereverb_wpe(affix_id=False).id == "pad"
    assert np.array_equal(pad.narrowband("mulaw").load_audio(), pad.load_audio())
    jpad = JPaddingCut(id="pad", duration=1.0, sampling_rate=SR, feat_value=-23.0, num_samples=SR)
    for op in ("narrowband", "dereverb_wpe"):
        assert not hasattr(jpad, op)


def test_mixed_cut_effects_need_a_recording():
    from lhotse_tpu_torch.testing.dummies import dummy_cut

    cut = dummy_cut(0, with_data=True)
    mixed = cut.drop_recording().mix(cut.drop_recording(), offset_other_by=0.5)
    with pytest.raises(AssertionError, match="narrowband"):
        mixed.narrowband("mulaw")
    with pytest.raises(AssertionError, match="WPE"):
        mixed.dereverb_wpe()
