"""
The port's extractors under the reference's names
(lhotse_tpu_torch.features.compliance, .kaldifeat, .whisper,
.librosa_fbank) against the JAX package's on the same seeded audio: every
name resolves in the port's registry, features agree within
tests/test_torch_extractors.py's tolerances (Whisper within
tests/test_whisper_fbank.py's 1e-4), config dicts are equal, and a
manifest the JAX package wrote with ``fbank`` features loads and mixes in
the port. The port runs on the CPU here (the fbank kernel's plain version,
plain GEMMs); its configs default to the card.
"""
import numpy as np
import pytest
import torch

import lhotse_tpu as J
import lhotse_tpu.features as JF
from lhotse_tpu.features import librosa_fbank as jlibrosa
from lhotse_tpu.features import whisper as jwhisper
import lhotse_tpu_torch.features as PF
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.features import librosa_fbank as plibrosa
from lhotse_tpu_torch.features import whisper as pwhisper
from lhotse_tpu_torch.features.base import FeatureExtractor, get_extractor_type
from lhotse_tpu_torch.utils import fix_random_seed
from lhotse_tpu.utils import fix_random_seed as jfix
from test_torch_extractors import TOL, _err, _items

SR = 16000
LIBROSA_SR = 22050
# Whisper: tests/test_whisper_fbank.py's bound; librosa (no JAX test bound
# of its own) is held to the same.
GEMM_TOL = 1e-4
# name -> (the class name in both packages, the port's config fields that pin
# the CPU (an extractor without a device field is moved with .to), the
# tolerance kind of tests/test_torch_extractors.py or None for GEMM_TOL)
CASES = {
    "fbank": ("TorchaudioFbank", {}, "Fbank"),
    "mfcc": ("TorchaudioMfcc", {}, "Mfcc"),
    "spectrogram": ("TorchaudioSpectrogram", {}, "LogSpectrogram"),
    "kaldifeat-fbank": ("KaldifeatFbank", {"device": "cpu"}, "Fbank"),
    "kaldifeat-mfcc": ("KaldifeatMfcc", {"device": "cpu"}, "Mfcc"),
    "whisper-fbank": ("WhisperFbank", {"device": "cpu"}, None),
    "librosa-fbank": ("LibrosaFbank", {}, None),
}
NAMES = sorted(CASES)


def _pair(name, **cfg):
    cls, pin, _ = CASES[name]
    jcls, pcls = getattr(JF, cls), getattr(PF, cls)
    jcfg = jcls.config_type(**cfg)
    pcfg = pcls.config_type(**cfg, **pin)
    ours = pcls(pcfg)
    if not pin:
        ours.to("cpu")
    return jcls(jcfg), ours


def _audio(name):
    if name == "librosa-fbank":
        rng = np.random.default_rng(1)
        return LIBROSA_SR, [(rng.standard_normal(n) * 0.1).astype(np.float32)
                            for n in (22050, 30000, 5000)]
    return SR, _items()


def _diff(name, a, b):
    kind = CASES[name][2]
    if kind is None:
        return float(np.abs(a.astype(np.float64) - b).max())
    return _err(kind, a, b)


def _tol(name):
    kind = CASES[name][2]
    return GEMM_TOL if kind is None else TOL[kind]


@pytest.mark.parametrize("name", NAMES)
def test_name_resolves_in_the_registry(name):
    cls = get_extractor_type(name)
    assert cls is getattr(PF, CASES[name][0]) and cls.name == name


@pytest.mark.parametrize("name", NAMES)
def test_extract_matches_jax(name):
    theirs, ours = _pair(name)
    sr, items = _audio(name)
    for x in items:
        a, b = theirs.extract(x, sr), ours.extract(x, sr)
        assert a.shape == b.shape and b.dtype == np.float32
        assert _diff(name, a, b) <= _tol(name), name


@pytest.mark.parametrize("name", ["fbank", "mfcc", "kaldifeat-fbank", "kaldifeat-mfcc"])
def test_extract_batch_matches_jax(name):
    theirs, ours = _pair(name)
    items = _items()
    a, b = theirs.extract_batch(items, SR), ours.extract_batch(items, SR)
    assert len(a) == len(b) == len(items)
    for x, y in zip(a, b):
        assert x.shape == y.shape and _diff(name, x, y) <= _tol(name)


@pytest.mark.parametrize("name", NAMES)
def test_config_dicts_and_dims_equal_jax(name):
    theirs, ours = _pair(name)
    assert ours.config.to_dict() == theirs.config.to_dict()
    assert ours.feature_dim(SR) == theirs.feature_dim(SR) and ours.frame_shift == theirs.frame_shift
    # The JAX package's extractor dict builds the port's extractor.
    rebuilt = FeatureExtractor.from_dict(theirs.to_dict())
    assert type(rebuilt) is type(ours) and rebuilt.config == ours.config
    assert type(ours.config).from_dict(theirs.config.to_dict()) == ours.config


@pytest.mark.parametrize("name", NAMES)
def test_extractors_default_to_the_card(name):
    cls = getattr(PF, CASES[name][0])
    assert cls().device == torch.device("cuda")


@pytest.mark.parametrize("name", ["kaldifeat-fbank", "kaldifeat-mfcc", "whisper-fbank"])
def test_a_jax_written_config_runs_on_the_cpu(name):
    """A dict the JAX package wrote carries its default ``device: cpu``."""
    theirs = getattr(JF, CASES[name][0])()
    ours = FeatureExtractor.from_dict(theirs.to_dict())
    assert ours.device == torch.device("cpu")
    x = _items()[0]
    assert _diff(name, theirs.extract(x, SR), ours.extract(x, SR)) <= _tol(name)


@pytest.mark.parametrize("name", ["fbank", "kaldifeat-mfcc", "librosa-fbank"])
def test_to_moves_the_delegates(name):
    _, ours = _pair(name)
    sr, items = _audio(name)
    ours.extract(items[0], sr)
    ours.to("cuda")
    assert ours.device == torch.device("cuda")
    with pytest.raises((AssertionError, RuntimeError)):
        ours.extract(items[0], sr)  # no card here


@pytest.mark.parametrize("name", ["fbank", "spectrogram", "kaldifeat-fbank", "librosa-fbank"])
def test_mix_energy_and_scale_equal_jax(name):
    jcls, pcls = getattr(JF, CASES[name][0]), getattr(PF, CASES[name][0])
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 50, 80)).astype(np.float32)
    np.testing.assert_array_equal(pcls.mix(a, b, 0.3), jcls.mix(a, b, 0.3))
    assert pcls.compute_energy(a) == jcls.compute_energy(a)
    if hasattr(jcls, "scale") and "scale" in vars(jcls):
        np.testing.assert_array_equal(pcls.scale(a, 0.5), jcls.scale(a, 0.5))


def test_whisper_refuses_mixing_like_jax():
    for cls in (JF.WhisperFbank, PF.WhisperFbank):
        with pytest.raises(ValueError, match="not defined"):
            cls.mix(np.zeros((2, 80)), np.zeros((2, 80)), 1.0)
        with pytest.raises(ValueError, match="not defined"):
            cls.compute_energy(np.zeros((2, 80)))


@pytest.mark.parametrize("kw", [{"vtln_warp": 1.1}, {"min_duration": 0.5}])
def test_compliance_asserts_like_jax(kw):
    for cls in (JF.TorchaudioFbank, PF.TorchaudioFbank):
        with pytest.raises(AssertionError):
            cls(cls.config_type(**kw))


@pytest.mark.parametrize("args", [(16000, 400, 80), (22050, 1024, 80, 80.0, 7600.0),
                                  (16000, 512, 128), (8000, 256, 40, 0.0, 3000.0)])
def test_slaney_mel_filters_equal_jax_bit_for_bit(args):
    ours, theirs = pwhisper.slaney_mel_filters(*args), jwhisper.slaney_mel_filters(*args)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_log_mel_spectrogram_equals_jax():
    x = _items()[0]
    ours = pwhisper.log_mel_spectrogram(x, n_mels=80, device="cpu")
    theirs = jwhisper.log_mel_spectrogram(x, n_mels=80)
    assert ours.shape == theirs.shape == (80, 100)
    assert np.abs(ours - theirs).max() <= GEMM_TOL
    window = np.hamming(400).astype(np.float32)
    ours = pwhisper.log_mel_spectrogram(x, n_mels=40, window=window, device="cpu")
    theirs = jwhisper.log_mel_spectrogram(x, n_mels=40, window=window)
    assert np.abs(ours - theirs).max() <= GEMM_TOL


@pytest.mark.parametrize("win_length", [None, 800])
def test_logmelfilterbank_equals_jax(win_length):
    _, items = _audio("librosa-fbank")
    for x in items:
        ours = plibrosa.logmelfilterbank(x, LIBROSA_SR, win_length=win_length, device="cpu")
        theirs = jlibrosa.logmelfilterbank(x, LIBROSA_SR, win_length=win_length)
        assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= GEMM_TOL


@pytest.mark.parametrize("frames", [99, 100, 101, 103])
def test_pad_or_truncate_features_equals_jax(frames):
    feats = np.arange(100 * 3, dtype=np.float32).reshape(100, 3)
    if abs(frames - 100) > 1:
        for fn in (plibrosa.pad_or_truncate_features, jlibrosa.pad_or_truncate_features):
            with pytest.raises(ValueError):
                fn(feats, frames)
        return
    np.testing.assert_array_equal(plibrosa.pad_or_truncate_features(feats, frames),
                                  jlibrosa.pad_or_truncate_features(feats, frames))


@pytest.mark.parametrize("name", ["kaldifeat-fbank", "kaldifeat-mfcc"])
def test_kaldifeat_lists_in_and_out(name):
    theirs, ours = _pair(name)
    items = _items()
    a, b = theirs.extract(items, SR), ours.extract(items, SR)
    assert isinstance(b, list) and len(b) == len(a)
    for x, y in zip(a, b):
        assert x.shape == y.shape and _diff(name, x, y) <= _tol(name)
    padded = np.zeros((2, 16000), np.float32)
    padded[0], padded[1, :12345] = items[0], items[1]
    lens = np.array([16000, 12345])
    a = theirs.extract_batch(padded, SR, lengths=lens)
    b = ours.extract_batch(padded, SR, lengths=lens)
    for x, y in zip(a, b):
        assert x.shape == y.shape and _diff(name, x, y) <= _tol(name)
    with pytest.raises(AssertionError, match="Mismatched sampling rate"):
        ours.extract(items[0], 8000)


@pytest.fixture(scope="module")
def fbank_manifest(tmp_path_factory):
    """Two cuts of noisy tones with ``fbank``-typed features the JAX package
    computed and stored in a ``lilcom_chunky`` archive."""
    from lhotse_tpu.audio.wavio import write_wav

    root = tmp_path_factory.mktemp("fbank_manifest")
    rng = np.random.default_rng(7)
    cuts = []
    for i, seconds in enumerate((2.0, 1.5)):
        n = int(SR * seconds)
        t = np.arange(n) / SR
        wave = 0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t) + 0.05 * rng.standard_normal(n)
        write_wav(str(root / f"r{i}.wav"), wave.astype(np.float32), SR)
        cuts.append(J.Recording.from_file(root / f"r{i}.wav").to_cut())
    J.CutSet.from_cuts(cuts).compute_and_store_features(
        JF.TorchaudioFbank(), root / "feats", progress_bar=False).to_file(root / "cuts.jsonl")
    return root


def test_jax_fbank_manifest_loads_and_mixes_in_the_port(fbank_manifest):
    ours = CutSet.from_file(fbank_manifest / "cuts.jsonl").to_eager()
    theirs = J.CutSet.from_file(fbank_manifest / "cuts.jsonl").to_eager()
    assert {c.features.type for c in ours} == {"fbank"}
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.load_features(), b.load_features())
    fix_random_seed(0)
    mixed = ours[0].mix(ours[1], offset_other_by=0.3, snr=10)
    jfix(0)
    jmixed = theirs[0].mix(theirs[1], offset_other_by=0.3, snr=10)
    got, want = mixed.load_features(), jmixed.load_features()
    assert got.shape == want.shape == (200, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # The stored features are the port's own extraction within half an LTC1 tick.
    fresh = PF.TorchaudioFbank()
    fresh.to("cpu")
    recomputed = fresh.extract(ours[0].load_audio(), SR)
    assert np.abs(recomputed - ours[0].load_features()).max() <= 2.0 ** -6 + TOL["Fbank"]
