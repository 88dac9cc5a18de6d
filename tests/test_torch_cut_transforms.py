"""
The augmented training path of the port at a small size, against the JAX
package: ``perturb_speed(1.1).mix(noise, snr=(10, 20), mix_prob=0.5,
seed=7)`` (the shape of ``bench.py::bench_host_pipeline``), the cut
transforms (``lhotse_tpu_torch.dataset.cut_transforms``) in
``K2SpeechRecognitionDataset`` over ``AudioSamples``, ``OnTheFlyFeatures``
and ``PrecomputedFeatures``, their random state saved by one package and
loaded by the other, ``LazyCutMixer``'s sequential seed, and the port's
post-transform window cache keyed by source.

Tolerances: audio runs the same numpy and C code on both sides and is
compared exactly; features extracted on the fly are held to the JAX fbank
layer's kernel route computed with its XLA ops at 1e-4 (ROADMAP's
like-for-like rule; the feature budget); mixed stored features, read from
one archive and mixed by the same numpy code, at 1e-5.
"""
import json
import random

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.dataset import cut_transforms as JT
from lhotse_tpu.dataset.input_strategies import AudioSamples as JAudioSamples
from lhotse_tpu.dataset.input_strategies import PrecomputedFeatures as JPrecomputed
from lhotse_tpu.dataset.speech_recognition import K2SpeechRecognitionDataset as JDataset
from lhotse_tpu.features.kaldi import layers as jl
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.caching import DecodedAudioCache, set_caching_enabled
from lhotse_tpu_torch.cut import CutSet, MixedCut
from lhotse_tpu_torch.dataset import cut_transforms as PT
from lhotse_tpu_torch.dataset.input_strategies import AudioSamples, OnTheFlyFeatures
from lhotse_tpu_torch.dataset.input_strategies import PrecomputedFeatures
from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
from lhotse_tpu_torch.features import Fbank, FbankConfig
from lhotse_tpu_torch.utils import fix_random_seed
from test_torch_layers import _jax_fused_route

SR = 16000
FEATURE_TOL = 1e-4  # on the fly vs the JAX layer's kernel route in XLA
FEATS_TOL = 1e-5  # mixed stored features


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight FLAC tone bursts of 0.6-1.6 s (bench.py's signal) and a
    4 x 2 s FLAC noise pool drawn after them from the same RandomState, as
    ``bench.py::_synthesize_corpus`` draws them; an RIR recording; and a
    JAX-written ``lilcom_chunky`` archive of both."""
    root = tmp_path_factory.mktemp("augmented_corpus")
    rng = np.random.RandomState(1234)

    def burst(seconds):
        n = int(SR * seconds)
        t = np.arange(n) / SR
        f0 = rng.uniform(80, 220)
        wave = sum(np.sin(2 * np.pi * f0 * (h + 1) * t) / (h + 1) for h in range(4)) * 0.2
        return (wave + rng.randn(n) * 0.01).astype(np.float32)

    cuts = []
    for i in range(8):
        duration = float(rng.uniform(0.6, 1.6))
        jwrite_flac(str(root / f"utt{i:02d}.flac"), burst(duration), SR)
        cut = J.Recording.from_file(root / f"utt{i:02d}.flac").to_cut()
        cut.supervisions.append(J.SupervisionSegment(
            id=f"sup{i:02d}", recording_id=cut.recording_id, start=0.0, duration=cut.duration,
            text="synthetic"))
        cuts.append(cut)
    J.CutSet.from_cuts(cuts).to_file(root / "cuts.jsonl")
    noise = []
    for i in range(4):
        jwrite_flac(str(root / f"noise{i:02d}.flac"), burst(2.0), SR)
        noise.append(J.Recording.from_file(root / f"noise{i:02d}.flac").to_cut())
    J.CutSet.from_cuts(noise).to_file(root / "noise.jsonl")
    n = SR // 5
    rir = np.exp(-np.arange(n) / (n / 6.0)) * np.random.default_rng(3).standard_normal(n) * 0.3
    rir[n // 50] = 1.0
    jwrite_flac(str(root / "rir.flac"), rir.astype(np.float32), SR)
    for name in ("cuts", "noise"):
        J.CutSet.from_file(root / f"{name}.jsonl").compute_and_store_features(
            J.Fbank(), root / f"{name}_feats", progress_bar=False).to_file(root / f"{name}_feats.jsonl")
    return root


def _load(corpus, pkg, name):
    return (CutSet if pkg == "port" else J.CutSet).from_file(corpus / f"{name}.jsonl")


def _lazy_augmented(corpus, pkg):
    cls = CutSet if pkg == "port" else J.CutSet
    return cls.from_jsonl_lazy(corpus / "cuts.jsonl").perturb_speed(1.1).mix(
        cls.from_file(corpus / "noise.jsonl"), snr=(10, 20), mix_prob=0.5, seed=7)


def test_perturb_speed_then_mix_equals_jax(corpus):
    """The same ids, track offsets and SNRs, epoch after epoch (the mixer's
    sequential seed is ``seed + num_times_iterated``), and the same audio."""
    fix_random_seed(0)
    jfix(0)
    ours, theirs = _lazy_augmented(corpus, "port"), _lazy_augmented(corpus, "jax")
    epochs = []
    for _ in range(3):
        fix_random_seed(1)
        a = [c.to_dict() for c in ours]
        jfix(1)
        b = [c.to_dict() for c in theirs]
        assert a == b
        epochs.append(a)
        sups = [s for c in a for t in c.get("tracks", [{"cut": c}]) for s in t["cut"].get(
            "supervisions", [])]
        assert len(sups) == 8 and all(s["id"].endswith("_sp1.1") for s in sups)
    assert epochs[0] != epochs[1]  # a new epoch draws new noise, SNRs and offsets
    mixed = [c for c in epochs[0] if c["type"] == "MixedCut"]
    assert 0 < len(mixed) < len(epochs[0])
    snrs = [t["snr"] for c in mixed for t in c["tracks"] if "snr" in t]
    assert snrs and all(10 <= s <= 20 for s in snrs)
    fix_random_seed(1)
    jfix(1)
    for a, b in zip(list(ours)[:3], list(theirs)[:3]):
        assert np.array_equal(a.load_audio(), b.load_audio())


def _transforms(corpus, pkg):
    """[PerturbSpeed, PerturbVolume, CutMix, ExtraPadding, Reverb], seeded."""
    m = PT if pkg == "port" else JT
    rec = (Recording if pkg == "port" else J.Recording).from_file(corpus / "rir.flac")
    return [
        m.PerturbSpeed(factors=[0.9, 1.1], p=2 / 3, randgen=random.Random(0)),
        m.PerturbVolume(p=0.5, randgen=random.Random(1)),
        m.CutMix(_load(corpus, pkg, "noise"), snr=(10, 20), p=0.6, seed=5),
        m.ExtraPadding(extra_seconds=0.2),
        m.ReverbWithImpulseResponse(rir_recordings=[rec], p=0.5, randgen=random.Random(3)),
    ]


def _batches(corpus, pkg, name="cuts"):
    cuts = list(_load(corpus, pkg, name))
    cls = CutSet if pkg == "port" else J.CutSet
    return [cls.from_cuts(cuts[i : i + 3]) for i in range(0, len(cuts), 3)]


def _run(dataset, batches, seed_fn):
    out = []
    for i, b in enumerate(batches):
        seed_fn(100 + i)
        out.append(dataset[b])
    return out


def _assert_supervisions_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if key == "cut":
            assert [c.to_dict() for c in a[key]] == [c.to_dict() for c in b[key]]
        elif isinstance(a[key], np.ndarray):
            assert np.array_equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


def test_cut_transforms_over_audio_samples_equal_jax(corpus):
    ours = _run(K2SpeechRecognitionDataset(
        return_cuts=True, cut_transforms=_transforms(corpus, "port"), input_strategy=AudioSamples()),
        _batches(corpus, "port"), fix_random_seed)
    theirs = _run(JDataset(
        return_cuts=True, cut_transforms=_transforms(corpus, "jax"), input_strategy=JAudioSamples()),
        _batches(corpus, "jax"), jfix)
    kinds = set()
    for a, b in zip(ours, theirs):
        assert a["inputs"].dtype == np.float32 and np.array_equal(a["inputs"], b["inputs"])
        _assert_supervisions_equal(a["supervisions"], b["supervisions"])
        kinds |= {type(c).__name__ for c in a["supervisions"]["cut"]}
        for c in a["supervisions"]["cut"]:
            kinds |= {type(t.cut).__name__ for t in getattr(c, "tracks", [])}
    assert {"MixedCut", "PaddingCut", "MonoCut"} <= kinds


def test_cut_transforms_on_the_fly_features_hold_to_jax_kernel_route(corpus):
    """``OnTheFlyFeatures(Fbank(device="cpu"))`` after the same transforms,
    against the JAX fbank layer's kernel route (XLA) over the JAX dataset's
    audio of the same batch."""
    ours = _run(K2SpeechRecognitionDataset(
        cut_transforms=_transforms(corpus, "port"),
        input_strategy=OnTheFlyFeatures(Fbank(FbankConfig(device="cpu")))),
        _batches(corpus, "port"), fix_random_seed)
    theirs = _run(JDataset(return_cuts=True, cut_transforms=_transforms(corpus, "jax"),
                           input_strategy=JAudioSamples()), _batches(corpus, "jax"), jfix)
    layer = jl.Wav2LogFilterBank()
    worst = 0.0
    for a, b in zip(ours, theirs):
        lens = [c.num_samples for c in b["supervisions"]["cut"]]  # one supervision per cut
        assert a["inputs"].shape[0] == len(lens)
        for i, n in enumerate(lens):
            want = np.asarray(_jax_fused_route(layer, b["inputs"][i : i + 1, :n]))[0]
            got = a["inputs"][i, : want.shape[0]]
            assert a["supervisions"]["num_frames"][i] <= want.shape[0] <= a["inputs"].shape[1]
            worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= FEATURE_TOL, worst


def test_cut_mix_on_precomputed_features_equals_jax(corpus):
    def transforms(pkg):
        m = PT if pkg == "port" else JT
        return [m.CutMix(_load(corpus, pkg, "noise_feats"), p=0.5, snr=(10, 20), preserve_id=True,
                         seed=7)]

    ours = _run(K2SpeechRecognitionDataset(
        return_cuts=True, cut_transforms=transforms("port"), input_strategy=PrecomputedFeatures()),
        _batches(corpus, "port", "cuts_feats"), fix_random_seed)
    theirs = _run(JDataset(
        return_cuts=True, cut_transforms=transforms("jax"), input_strategy=JPrecomputed()),
        _batches(corpus, "jax", "cuts_feats"), jfix)
    mixed = 0
    for a, b in zip(ours, theirs):
        assert a["inputs"].shape == b["inputs"].shape
        np.testing.assert_allclose(a["inputs"], b["inputs"], rtol=0, atol=FEATS_TOL)
        _assert_supervisions_equal(a["supervisions"], b["supervisions"])
        for i, cut in enumerate(a["supervisions"]["cut"]):
            if isinstance(cut, MixedCut):
                mixed += 1
                lead = cut.tracks[0].cut.load_features()
                # Mixing adds energy: never below the lead track's features.
                assert (a["inputs"][i, : len(lead)] >= lead - 1e-6).all()
    assert mixed > 0


@pytest.mark.parametrize("name", ["PerturbSpeed", "PerturbTempo", "PerturbVolume", "CutMix", "Reverb"])
def test_transform_state_saved_by_jax_loads_into_port(corpus, name):
    """A JAX transform's ``state_dict()`` after one batch, through JSON,
    into a fresh port transform: the next batch is the same."""
    def make(pkg, seed):
        m = PT if pkg == "port" else JT
        rng = random.Random(seed)
        rec = (Recording if pkg == "port" else J.Recording).from_file(corpus / "rir.flac")
        return {
            "PerturbSpeed": lambda: m.PerturbSpeed(factors=[0.9, 1.1], p=0.5, randgen=rng),
            "PerturbTempo": lambda: m.PerturbTempo(factors=[0.9, 1.1], p=0.5, randgen=rng),
            "PerturbVolume": lambda: m.PerturbVolume(p=0.5, randgen=rng),
            "CutMix": lambda: m.CutMix(_load(corpus, pkg, "noise"), p=0.5, seed=rng),
            "Reverb": lambda: m.ReverbWithImpulseResponse([rec], p=0.5, randgen=rng),
        }[name]()

    jax_t = make("jax", 11)
    (first, second, third) = _batches(corpus, "jax")
    jfix(0)
    jax_t(first)
    state = json.loads(json.dumps(jax_t.state_dict()))
    ours_t = make("port", 99)
    ours_t.load_state_dict(state)
    assert ours_t.state_dict() == state
    for jax_batch, port_batch in zip((second, third), _batches(corpus, "port")[1:]):
        jfix(1)
        want = [c.to_dict() for c in jax_t(jax_batch)]
        fix_random_seed(1)
        got = [c.to_dict() for c in ours_t(port_batch)]
        assert got == want
    assert PT.PerturbSpeed(0.9, p=1.0).state_dict()["rng_state"]["version"] == 3


def test_lazy_cut_mixer_sequential_seed(corpus):
    """``seed`` as an int: epoch k of the port's mixer draws what epoch k of
    JAX's draws; as a ``random.Random``: the instance's stream continues
    across epochs in both. Over non-indexed noise, checkpoints and
    constant-time access raise (tests/test_torch_shar.py holds the indexed
    regime to JAX's)."""
    for seed in (7, "rng"):
        def mixed(pkg):
            cls = CutSet if pkg == "port" else J.CutSet
            s = random.Random(5) if seed == "rng" else seed
            return cls.from_jsonl_lazy(corpus / "cuts.jsonl").mix(
                cls.from_file(corpus / "noise.jsonl"), snr=(5, 15), mix_prob=0.7, seed=s,
                random_mix_offset=True, preserve_id="left")

        ours, theirs = mixed("port"), mixed("jax")
        for epoch in range(3):
            assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs], (seed, epoch)
        assert ours.data.num_times_iterated == theirs.data.num_times_iterated == 3
    with pytest.raises(NotImplementedError, match="checkpoint"):
        ours.data.state_dict()

    with pytest.raises(TypeError, match="constant-time"):
        ours.data[0]
    assert not ours.data.is_checkpointable and not ours.data.has_constant_time_access


def test_post_transform_cache_keys_by_source(tmp_path):
    """Two recordings with one id but different audio, under one
    ``perturb_speed`` chain with the decoded-audio cache on: each gets its
    own window (the JAX package keys the window by ``Recording.id`` and
    keeps this fault)."""
    rng = np.random.default_rng(0)
    recs = []
    for name in ("a", "b"):
        write_flac(str(tmp_path / f"{name}.flac"),
                   (rng.standard_normal(SR) * 0.1).astype(np.float32), SR)
        recs.append(Recording.from_file(tmp_path / f"{name}.flac", recording_id="same").perturb_speed(1.1))
    assert recs[0].id == recs[1].id
    fresh = [r.load_audio(offset=0.1, duration=0.5) for r in recs]
    assert not np.array_equal(*fresh)
    set_caching_enabled(True)
    DecodedAudioCache.clear()
    try:
        for _ in range(3):  # first sighting, cached, served from the cache
            for rec, want in zip(recs, fresh):
                assert np.array_equal(rec.load_audio(offset=0.1, duration=0.5), want)
    finally:
        set_caching_enabled(False)


@pytest.mark.parametrize("name", ["ClippingTransform", "Compress", "CutConcatenate",
                                  "LowpassUsingResampling"])
def test_left_out_cut_transforms_raise(name):
    assert hasattr(JT, name)
    with pytest.raises(NotImplementedError, match=name):
        getattr(PT, name)()
