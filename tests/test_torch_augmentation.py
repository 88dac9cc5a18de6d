"""
The port's host audio transforms (lhotse_tpu_torch.augmentation and the
transform chain of ``Recording.load_audio``) against the JAX package's, on
the same seeded numpy inputs.

Both packages run the same code here: the polyphase resampler is the same
``dsp`` C source (``sinc_resample_f32``), WSOLA, gain, FFT convolution and
the FRA-RIR generator the same numpy and scipy calls. So every comparison is
``np.array_equal`` (exact); none needs a tolerance.
"""
import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu import augmentation as JA
from lhotse_tpu.augmentation import utils as JU
from lhotse_tpu_torch import augmentation as PA
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.augmentation import utils as PU
from lhotse_tpu_torch.caching import set_caching_enabled

SR = 16000


def _wave(seed, seconds=1.3, channels=1):
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(90, 300) * t) + 0.05 * rng.standard_normal((channels, n))
    return x.astype(np.float32)


def _rir(seed=5, seconds=0.3):
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    rir = (np.exp(-np.arange(n) / (n / 6.0)) * rng.standard_normal(n) * 0.3).astype(np.float32)
    rir[n // 50] = 1.0
    return rir


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A speech-like FLAC and an RIR FLAC, with both packages' Recordings."""
    root = tmp_path_factory.mktemp("augmentation")
    write_flac(str(root / "utt.flac"), _wave(1, 2.1)[0], SR)
    write_flac(str(root / "rir.flac"), _rir(), SR)
    return {
        name: (Recording.from_file(root / f"{name}.flac"), J.Recording.from_file(root / f"{name}.flac"))
        for name in ("utt", "rir")}


@pytest.mark.parametrize("factor", [0.9, 1.1])
def test_speed_equals_jax(factor):
    x = _wave(int(factor * 10))
    ours, theirs = PA.Speed(factor)(x, SR), JA.Speed(factor)(x, SR)
    assert ours.shape == theirs.shape and abs(ours.shape[1] - x.shape[1] / factor) < 1
    assert ours.dtype == np.float32 and np.array_equal(ours, theirs)


@pytest.mark.parametrize("factor", [0.9, 1.1])
def test_tempo_equals_jax(factor):
    x = _wave(int(factor * 20))
    ours, theirs = PA.Tempo(factor)(x, SR), JA.Tempo(factor)(x, SR)
    assert ours.shape == theirs.shape and np.array_equal(ours, theirs)


def test_volume_equals_jax():
    x = _wave(3)
    assert np.array_equal(PA.Volume(0.37)(x, SR), JA.Volume(0.37)(x, SR))


@pytest.mark.parametrize("source,target", [(16000, 8000), (8000, 16000)])
def test_resample_equals_jax(source, target):
    x = _wave(source // 1000, channels=2)
    ours = PA.Resample(source, target)(x)
    theirs = JA.Resample(source, target)(x)
    assert ours.shape == theirs.shape == (2, x.shape[1] * target // source)
    assert np.array_equal(ours, theirs)
    assert np.array_equal(PA.resample_array(x[0], source, target), JA.resample_array(x[0], source, target))


def test_convolve1d_equals_jax():
    x, k = _wave(4)[0].astype(np.float64), _rir().astype(np.float64)
    ours = PU.convolve1d(x, k)
    assert ours.shape == (x.size + k.size - 1,) and np.array_equal(ours, JU.convolve1d(x, k))
    assert [PU.next_fast_len(n) for n in (1, 97, 1000, 24001)] == [
        JU.next_fast_len(n) for n in (1, 97, 1000, 24001)]


@pytest.mark.parametrize("early_only,normalize", [(False, True), (True, True), (False, False)])
def test_reverb_with_given_rir_equals_jax(files, early_only, normalize):
    ours_rir, jax_rir = files["rir"]
    x = _wave(6)
    ours = PA.ReverbWithImpulseResponse(rir=ours_rir, early_only=early_only, normalize_output=normalize)
    theirs = JA.ReverbWithImpulseResponse(rir=jax_rir, early_only=early_only, normalize_output=normalize)
    got, want = ours(x, SR), theirs(x, SR)
    assert got.shape == x.shape and np.array_equal(got, want)


def test_reverb_with_fast_random_rir_generator_equals_jax():
    ours_gen = PU.FastRandomRIRGenerator(sr=SR, room_seed=11, source_seed=12)
    jax_gen = JU.FastRandomRIRGenerator(sr=SR, room_seed=11, source_seed=12)
    assert ours_gen.to_dict() == jax_gen.to_dict()
    rir = ours_gen(nsource=1)
    assert rir.ndim == 2 and rir.shape[0] == 1 and np.array_equal(rir, jax_gen(nsource=1))
    x = _wave(7)
    ours = PA.ReverbWithImpulseResponse(rir_generator=PU.FastRandomRIRGenerator(room_seed=3, source_seed=4))
    theirs = JA.ReverbWithImpulseResponse(rir_generator=JU.FastRandomRIRGenerator(room_seed=3, source_seed=4))
    assert not ours.is_deterministic and not theirs.is_deterministic
    for _ in range(2):  # successive calls draw fresh rooms from the same seeded stream
        assert np.array_equal(ours(x, SR), theirs(x, SR))


@pytest.mark.parametrize("offset,duration", [(0.0, None), (0.37, 0.5), (1.0, None), (0.0001, 1.2345)])
def test_reverse_timestamps_equal_jax(offset, duration):
    pairs = [
        (PA.Speed(1.1), JA.Speed(1.1)), (PA.Speed(0.9), JA.Speed(0.9)),
        (PA.Tempo(1.1), JA.Tempo(1.1)), (PA.Volume(2.0), JA.Volume(2.0)),
        (PA.Resample(16000, 8000), JA.Resample(16000, 8000)),
        (PA.Resample(8000, 22050), JA.Resample(8000, 22050)),
        (PA.ReverbWithImpulseResponse(rir_generator={"room_seed": 1}),
         JA.ReverbWithImpulseResponse(rir_generator={"room_seed": 1}))]
    for ours, theirs in pairs:
        assert ours.reverse_timestamps(offset, duration, SR) == theirs.reverse_timestamps(
            offset, duration, SR), type(ours).__name__


def test_transform_dicts_cross_packages(files):
    ours_rir, jax_rir = files["rir"]
    pairs = [
        (PA.Speed(1.1), JA.Speed(1.1)), (PA.Tempo(0.9), JA.Tempo(0.9)),
        (PA.Volume(0.5), JA.Volume(0.5)), (PA.Resample(16000, 8000), JA.Resample(16000, 8000)),
        (PA.ReverbWithImpulseResponse(rir=ours_rir, early_only=True, rir_channels=[0]),
         JA.ReverbWithImpulseResponse(rir=jax_rir, early_only=True, rir_channels=[0])),
        (PA.ReverbWithImpulseResponse(rir_generator=PU.FastRandomRIRGenerator(room_seed=2, source_seed=3)),
         JA.ReverbWithImpulseResponse(rir_generator=JU.FastRandomRIRGenerator(room_seed=2, source_seed=3)))]
    for ours, theirs in pairs:
        d = ours.to_dict()
        assert d == theirs.to_dict()
        assert JA.AudioTransform.from_dict(d).to_dict() == d
        assert PA.AudioTransform.from_dict(theirs.to_dict()).to_dict() == d


@pytest.mark.parametrize("name", ["Narrowband", "Compress", "Clipping", "LoudnessNormalization",
                                  "DereverbWPE"])
def test_left_out_transforms_raise(files, name):
    rec = files["utt"][0]
    if name == "DereverbWPE":
        # The host WPE transform is ported: a manifest naming it reads, and
        # the builder appends it as the JAX package's does.
        assert PA.AudioTransform.from_dict({"name": name, "kwargs": {}}) == PA.DereverbWPE()
        jrec = J.Recording.from_dict(rec.to_dict())
        assert rec.dereverb_wpe().to_dict() == jrec.dereverb_wpe().to_dict()
        return
    # Ported: a JAX-written transform dict reads as the same transform, and
    # the builder appends it as the JAX package's does.
    build = {"Narrowband": lambda r: r.narrowband("mulaw"),
             "Compress": lambda r: r.compress("opus", 0.5),
             "Clipping": lambda r: r.clip_amplitude(hard=True, gain_db=3.0),
             "LoudnessNormalization": lambda r: r.normalize_loudness(-20)}[name]
    jrec = build(J.Recording.from_dict(rec.to_dict()))
    written = [t if isinstance(t, dict) else t.to_dict() for t in jrec.transforms]
    ours = [PA.AudioTransform.from_dict(d) for d in written]
    assert [t.to_dict() for t in ours] == written
    assert any(type(t).__name__ == name for t in ours)
    assert build(rec).to_dict() == jrec.to_dict()
    x = _wave(3)
    for t, d in zip(ours, written):
        assert np.array_equal(t(x, SR), JA.AudioTransform.from_dict(d)(x, SR))


def test_resampler_has_no_numpy_fallback(monkeypatch):
    """The resampler calls the C ``sinc_resample_f32``; a library that
    cannot be built raises instead of taking a numpy route."""
    from lhotse_tpu_torch.ops import host_dsp

    calls = []
    real = host_dsp.sinc_resample

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(host_dsp, "sinc_resample", counting)
    PA.Speed(1.1)(_wave(8), SR)
    assert calls == [1]

    def broken():
        raise RuntimeError("the dsp library failed to build")

    monkeypatch.setattr(host_dsp, "_get_lib", broken)
    with pytest.raises(RuntimeError, match="failed to build"):
        PA.Resample(16000, 8000)(_wave(9))


def test_sox_resampling_backend_is_not_ported(monkeypatch):
    # Without a sox binary on PATH the backend is not listed, and choosing it
    # raises ValueError as in the JAX package (tests/test_torch_sox.py runs
    # it through a stub binary).
    monkeypatch.setenv("LHOTSE_TPU_RESAMPLING_BACKEND", "sox")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(ValueError, match="sox"):
        PA.Resample(16000, 8000)(_wave(10))


CHAINS = {
    "speed": lambda r: r.perturb_speed(1.1),
    "tempo": lambda r: r.perturb_tempo(0.9),
    "volume+speed": lambda r: r.perturb_volume(0.5).perturb_speed(0.9),
    "resample": lambda r: r.resample(8000),
    "speed+resample": lambda r: r.perturb_speed(1.1).resample(22050),
}


@pytest.mark.parametrize("caching", [False, True])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_recording_transform_chain_equals_jax(files, chain, caching):
    """``load_audio`` through a transform chain, whole and windowed: the
    window mapped back through ``reverse_timestamps``; read twice so the
    second pass goes through the decoded-audio caches when they are on."""
    ours, theirs = (CHAINS[chain](r) for r in files["utt"])
    assert ours.to_dict() == theirs.to_dict()
    assert Recording.from_dict(theirs.to_dict()).to_dict() == ours.to_dict()
    set_caching_enabled(caching)
    J.set_caching_enabled(caching)
    try:
        for _ in range(2):
            for offset, duration in [(0.0, None), (0.25, 0.5), (0.6, None), (0.0, 1.0)]:
                a = ours.load_audio(offset=offset, duration=duration)
                b = theirs.load_audio(offset=offset, duration=duration)
                assert a.dtype == b.dtype and np.array_equal(a, b), (chain, offset, duration)
    finally:
        set_caching_enabled(False)
        J.set_caching_enabled(False)


def test_recording_reverb_rir_equals_jax(files):
    (ours, theirs), (ours_rir, jax_rir) = files["utt"], files["rir"]
    a = ours.reverb_rir(ours_rir, early_only=True)
    b = theirs.reverb_rir(jax_rir, early_only=True)
    assert a.to_dict() == b.to_dict()
    assert np.array_equal(a.load_audio(offset=0.2, duration=1.0), b.load_audio(offset=0.2, duration=1.0))
    a = ours.reverb_rir(room_rng_seed=7, source_rng_seed=8)
    b = theirs.reverb_rir(room_rng_seed=7, source_rng_seed=8)
    assert a.to_dict() == b.to_dict()
    assert np.array_equal(a.load_audio(), b.load_audio())
