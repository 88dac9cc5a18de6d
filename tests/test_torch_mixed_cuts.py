"""
The port's PaddingCut and MixedCut (lhotse_tpu_torch.cut.padding,
lhotse_tpu_torch.cut.mixed and the cut algebra of cut/base.py, data.py,
mono.py and set.py), its manifests and the padded collation routes, against
the JAX package's on the same files and seeds.

Both packages number new cuts with ``uuid4()``; each builder below runs
after ``fix_random_seed(0)`` in its package, so the manifests come out equal
id for id. Audio goes through the same numpy code on both sides (the
``dsp`` resampler, AudioMixer's sums, FFT reverb) and is compared exactly;
mixed stored features go through the same numpy ``Fbank.mix`` on the same
archive and are compared at 1e-5.
"""
import itertools
import json

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.flacio import write_flac as jwrite_flac
from lhotse_tpu.cut import set as jset
from lhotse_tpu.dataset import collation as jcol
from lhotse_tpu.utils import fix_random_seed as jfix
from lhotse_tpu_torch import cut as P
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.cut import CutSet, MixedCut, MonoCut, PaddingCut
from lhotse_tpu_torch.dataset import collation as pcol
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.utils import fix_random_seed

SR = 16000
# Mixed stored features: the same LTC1 archive and the same numpy mix on
# both sides (the slice's bound for mixed stored features).
FEATS_TOL = 1e-5


def _both(build):
    """``build(pkg)`` for the port and for JAX, each after seeding its uuid4."""
    fix_random_seed(0)
    ours = build("port")
    jfix(0)
    theirs = build("jax")
    return ours, theirs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five FLAC utterances of 0.8-1.9 s (one supervision each, one with an
    alignment and a second supervision) and two 1.5 s noise files, written
    by the JAX package, with JAX-written manifests and a JAX-written
    ``lilcom_chunky`` archive of their fbank features."""
    root = tmp_path_factory.mktemp("mixed_corpus")
    rng = np.random.default_rng(21)
    cuts = []
    for i in range(5):
        n = int(SR * rng.uniform(0.8, 1.9))
        t = np.arange(n) / SR
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(90, 250) * t) + 0.02 * rng.standard_normal(n)
        jwrite_flac(str(root / f"u{i}.flac"), x.astype(np.float32), SR)
        cut = J.Recording.from_file(root / f"u{i}.flac").to_cut()
        half = round(cut.duration / 2, 3)
        cut.supervisions.append(J.SupervisionSegment(
            id=f"s{i}", recording_id=cut.recording_id, start=0.0,
            duration=half if i == 2 else cut.duration, text=f"text {i}", speaker=f"spk{i % 2}"))
        if i == 2:
            cut.supervisions.append(J.SupervisionSegment(
                id="s2b", recording_id=cut.recording_id, start=half,
                duration=round(cut.duration - half, 3), text="second", speaker="spk1"))
            item = J.AlignmentItem
            cut.supervisions[0] = cut.supervisions[0].with_alignment(
                "word", [item("text", 0.0, 0.2), item("2", 0.2, 0.1)])
        cuts.append(cut)
    J.CutSet.from_cuts(cuts).to_file(root / "cuts.jsonl")
    noise = []
    for i in range(2):
        x = (rng.standard_normal(int(1.5 * SR)) * 0.05).astype(np.float32)
        jwrite_flac(str(root / f"n{i}.flac"), x, SR)
        noise.append(J.Recording.from_file(root / f"n{i}.flac").to_cut())
    J.CutSet.from_cuts(noise).to_file(root / "noise.jsonl")
    feats = J.CutSet.from_file(root / "cuts.jsonl").compute_and_store_features(
        J.Fbank(), root / "feats", progress_bar=False)
    feats.to_file(root / "feats.jsonl")
    noise_feats = J.CutSet.from_file(root / "noise.jsonl").compute_and_store_features(
        J.Fbank(), root / "noise_feats", progress_bar=False)
    noise_feats.to_file(root / "noise_feats.jsonl")
    return root


def _cuts(corpus, pkg, name="cuts"):
    cls = CutSet if pkg == "port" else J.CutSet
    return list(cls.from_file(corpus / f"{name}.jsonl"))


def _mod(pkg):
    return P if pkg == "port" else J.cut


BUILDERS = {
    "mix": lambda c, n, m: c[0].mix(n[0], offset_other_by=0.3, snr=10),
    "mix_allow_padding": lambda c, n, m: c[1].mix(n[1], offset_other_by=2.5, allow_padding=True, snr=5),
    "mix_preserve_tag": lambda c, n, m: c[0].mix(n[0], snr=None, preserve_id="left", tag="noise"),
    "append": lambda c, n, m: c[0].append(c[1], snr=3),
    "mix_cuts": lambda c, n, m: m.mix_cuts([c[0], c[1], n[0]]),
    "append_cuts": lambda c, n, m: m.append_cuts([c[2], c[3], c[4]]),
    "pad_right": lambda c, n, m: c[0].pad(duration=2.5),
    "pad_left": lambda c, n, m: c[1].pad(duration=2.5, direction="left"),
    "pad_both": lambda c, n, m: c[2].pad(duration=2.5, direction="both", preserve_id=True),
    "pad_samples": lambda c, n, m: c[3].pad(num_samples=40000, direction="left"),
    "pad_mix": lambda c, n, m: c[0].mix(n[0], snr=10).pad(duration=3.0, direction="both"),
    "truncate_mix": lambda c, n, m: c[4].mix(n[1], offset_other_by=0.2, snr=12).truncate(
        offset=0.1, duration=0.9),
    "truncate_mix_to_lead": lambda c, n, m: c[0].pad(duration=3.0).truncate(duration=0.5),
    "truncate_mono": lambda c, n, m: c[2].truncate(offset=0.15, duration=0.5),
    "extend_by": lambda c, n, m: c[1].truncate(offset=0.2, duration=0.4).extend_by(
        duration=0.5, direction="both"),
    "perturb_speed_mix": lambda c, n, m: c[0].mix(n[1], offset_other_by=0.1, snr=8).perturb_speed(1.1),
    "perturb_tempo_mix": lambda c, n, m: c[3].mix(n[0], snr=8).perturb_tempo(0.9),
    "perturb_volume_mix": lambda c, n, m: c[3].pad(duration=2.0).perturb_volume(0.5),
    "reverb_mix_first": lambda c, n, m: c[2].mix(n[0], snr=15).reverb_rir(room_rng_seed=3,
                                                                          source_rng_seed=4),
    "reverb_per_track": lambda c, n, m: c[2].mix(n[0], snr=15).reverb_rir(mix_first=False),
    "resample_mix": lambda c, n, m: c[1].mix(n[0], snr=10).resample(8000),
    "fill_supervision": lambda c, n, m: c[0].pad(duration=2.2).fill_supervision(shrink_ok=True),
    "drop_supervisions": lambda c, n, m: c[0].mix(n[0], snr=10).drop_supervisions(),
    "merge_supervisions": lambda c, n, m: c[2].append(c[0]).merge_supervisions(),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_equal_jax(corpus, name):
    """The manifest (``to_dict()``) and the audio of each builder."""
    ours, theirs = _both(lambda pkg: BUILDERS[name](
        _cuts(corpus, pkg), _cuts(corpus, pkg, "noise"), _mod(pkg)))
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.to_dict() == theirs.to_dict()
    assert ours.duration == theirs.duration and ours.num_samples == theirs.num_samples
    a, b = ours.load_audio(), theirs.load_audio()
    assert a.dtype == b.dtype == np.float32 and a.shape == (1, ours.num_samples)
    assert np.array_equal(a, b)
    if isinstance(ours, MixedCut):
        for x, y in zip(ours.load_audio(mixed=False), theirs.load_audio(mixed=False)):
            assert np.array_equal(x, y)
        assert [c.to_dict() for c in ours.unmix()] == [c.to_dict() for c in theirs.unmix()]


@pytest.mark.parametrize("name", ["pad_frames", "mix_feats", "mix_feats_snr_ref", "pad_left_feats",
                                  "truncate_feats"])
def test_load_features_of_mixed_stored_features_equals_jax(corpus, name):
    """Feature-domain mixing over a JAX-written archive: ``FeatureMixer``
    with ``Fbank.mix``/``compute_energy``."""
    builders = {
        "pad_frames": lambda c, n: c[0].pad(num_frames=300),
        "mix_feats": lambda c, n: c[1].mix(n[0], offset_other_by=0.4, snr=10),
        "mix_feats_snr_ref": lambda c, n: c[2].pad(duration=2.5, direction="left").mix(n[1], snr=6),
        "pad_left_feats": lambda c, n: c[3].pad(num_frames=260, direction="left"),
        "truncate_feats": lambda c, n: c[4].mix(n[0], snr=10).truncate(offset=0.2, duration=0.7),
    }
    ours, theirs = _both(lambda pkg: builders[name](
        _cuts(corpus, pkg, "feats"), _cuts(corpus, pkg, "noise_feats")))
    assert ours.to_dict() == theirs.to_dict()
    a, b = ours.load_features(), theirs.load_features()
    assert a.shape == b.shape == (ours.num_frames, 80)
    np.testing.assert_allclose(a, b, rtol=0, atol=FEATS_TOL)
    if isinstance(ours, MixedCut):
        np.testing.assert_allclose(
            ours.load_features(mixed=False), theirs.load_features(mixed=False), rtol=0, atol=FEATS_TOL)


def _augmented(pkg, corpus):
    cuts = _cuts(corpus, pkg)
    noise = _cuts(corpus, pkg, "noise")
    cls = CutSet if pkg == "port" else J.CutSet
    rec = cuts[4].recording
    return cls.from_cuts([
        cuts[0].mix(noise[0], snr=10), cuts[1].pad(duration=2.5, direction="both"),
        cuts[2].perturb_speed(1.1).mix(noise[1], offset_other_by=0.2, snr=5),
        cuts[3].reverb_rir(rec, early_only=True), cuts[4].perturb_tempo(0.9).perturb_volume(0.7),
        PaddingCut(id="pad", duration=0.5, sampling_rate=SR, feat_value=-23.0, num_samples=8000)])


def test_manifests_written_by_jax_load_in_port(corpus, tmp_path):
    jfix(0)
    theirs = _augmented("jax", corpus)
    theirs.to_file(tmp_path / "jax.jsonl")
    ours = list(CutSet.from_jsonl_lazy(tmp_path / "jax.jsonl"))
    assert [c.to_dict() for c in ours] == [c.to_dict() for c in theirs]
    assert [type(c).__name__ for c in ours] == [
        "MixedCut", "MixedCut", "MixedCut", "MonoCut", "MonoCut", "PaddingCut"]
    assert ours[3].recording.transforms and ours[4].recording.transforms
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.load_audio(), b.load_audio()), a.id


def test_manifests_written_by_port_load_in_jax(corpus, tmp_path):
    fix_random_seed(0)
    ours = _augmented("port", corpus)
    ours.to_file(tmp_path / "port.jsonl")
    with open(tmp_path / "port.jsonl") as f:
        lines = f.readlines()
    # JAX's lazy reader has no PaddingCut branch; its deserialize_cut does.
    theirs = [jset.deserialize_cut(json.loads(x)) for x in lines]
    assert [c.to_dict() for c in theirs] == [c.to_dict() for c in ours]
    lazy = itertools.islice(J.CutSet.from_jsonl_lazy(tmp_path / "port.jsonl"), 5)
    assert [c.to_dict() for c in lazy] == [json.loads(x) for x in lines[:5]]
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.load_audio(), b.load_audio()), a.id


def _collate_inputs(pkg, corpus):
    cuts = _cuts(corpus, pkg)
    noise = _cuts(corpus, pkg, "noise")
    cls = CutSet if pkg == "port" else J.CutSet
    return cls.from_cuts([cuts[0], cuts[1].mix(noise[0], snr=10), cuts[2].perturb_speed(0.9), cuts[3]])


@pytest.mark.parametrize("kwargs", [
    {}, {"pad_direction": "left"}, {"pad_direction": "both"}, {"mono_downmix": True},
    {"mono_downmix": False}, {"pad_to_multiple": 1000}], ids=str)
def test_collate_audio_padded_route_equals_jax(corpus, kwargs):
    ours, theirs = _both(lambda pkg: (pcol if pkg == "port" else jcol).collate_audio(
        _collate_inputs(pkg, corpus), **kwargs))
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if kwargs.get("mono_downmix") is False:
        assert ours[0].ndim == 3  # (batch, channels, time) on the padded route


@pytest.mark.parametrize("kwargs", [{}, {"mono_downmix": True}], ids=str)
def test_collate_audio_fault_tolerant_equals_jax(corpus, kwargs):
    def run(pkg):
        cuts = list(_collate_inputs(pkg, corpus))
        bad = cuts[3]
        broken = bad.recording.copy_with(sources=[
            type(bad.recording.sources[0])(type="file", channels=[0], source=str(corpus / "missing.flac"))])
        cuts[3] = type(bad)(**{**bad.__dict__, "recording": broken})
        cls = CutSet if pkg == "port" else J.CutSet
        return (pcol if pkg == "port" else jcol).collate_audio(
            cls.from_cuts(cuts), fault_tolerant=True, **kwargs)

    ours, theirs = _both(run)
    assert np.array_equal(ours[0], theirs[0]) and np.array_equal(ours[1], theirs[1])
    assert len(ours[2]) == 3 and [c.to_dict() for c in ours[2]] == [c.to_dict() for c in theirs[2]]


def test_collate_audio_custom_recording_field_equals_jax(corpus):
    def run(pkg):
        cuts = _cuts(corpus, pkg)
        for c, other in zip(cuts, cuts[1:] + cuts[:1]):
            c.target = other.recording
            c.custom["target_unaligned"] = True
        cls = CutSet if pkg == "port" else J.CutSet
        return (pcol if pkg == "port" else jcol).collate_audio(
            cls.from_cuts(cuts), recording_field="target")

    ours, theirs = _both(run)
    assert np.array_equal(ours[0], theirs[0]) and np.array_equal(ours[1], theirs[1])


@pytest.mark.parametrize("direction", ["right", "left", "both"])
def test_collate_features_pad_direction_equals_jax(corpus, direction):
    ours, theirs = _both(lambda pkg: (pcol if pkg == "port" else jcol).collate_features(
        (CutSet if pkg == "port" else J.CutSet).from_cuts(_cuts(corpus, pkg, "feats")),
        pad_direction=direction))
    assert ours[0].shape == theirs[0].shape and np.array_equal(ours[1], theirs[1])
    np.testing.assert_allclose(ours[0], theirs[0], rtol=0, atol=FEATS_TOL)


def test_validate_mixed_and_padding_cuts(corpus):
    cuts, noise = _cuts(corpus, "port"), _cuts(corpus, "port", "noise")
    for cut in [cuts[0].mix(noise[0], snr=10), cuts[1].pad(duration=3.0, direction="both"),
                PaddingCut(id="p", duration=1.0, sampling_rate=SR, feat_value=0.0, num_samples=SR)]:
        validate(cut, read_data=True)
    bad = cuts[0].mix(noise[0], snr=10)
    bad.tracks[1].offset = -0.1
    with pytest.raises(AssertionError, match="negative offset"):
        validate(bad)


def test_left_out_methods_raise(corpus):
    cuts, noise = _cuts(corpus, "port"), _cuts(corpus, "port", "noise")
    mixed = cuts[0].mix(noise[0], snr=10)
    with pytest.raises(NotImplementedError):
        mixed.load_video()
    # The track plots are ported (tests/test_torch_plots.py holds them to JAX).
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assert len(mixed.plot_tracks_audio()) == 2
    plt.close("all")
    # Compress is ported: the same manifest as the JAX package's builder.
    jmixed = _cuts(corpus, "jax")[0].mix(_cuts(corpus, "jax", "noise")[0], snr=10)
    assert [t.cut.to_dict() for t in mixed.compress("mp3", 0.5).tracks] == [
        t.cut.to_dict() for t in jmixed.compress("mp3", 0.5).tracks]
    # Narrowband is ported: the same manifest as the JAX package's builder.
    assert cuts[0].narrowband("mulaw").to_dict() == _cuts(corpus, "jax")[0].narrowband(
        "mulaw").to_dict()
    # MultiCut is ported: to_mono renders the mix, several channels make a
    # MultiCut and a MultiCut manifest reads.
    mono = mixed.to_mono()
    assert isinstance(mono, MonoCut) and mono.recording.is_in_memory
    # The rendering goes through 16-bit WAV: one step of 2**-15 at most.
    np.testing.assert_allclose(
        mono.load_audio(), mixed.load_audio(mono_downmix=True), rtol=0, atol=2.0 ** -15)
    assert type(cuts[0].with_channels([0, 0])).__name__ == "MultiCut"
    line = cuts[0].to_dict()
    # deserialize_cut mutates the dict it is given.
    multi = P.deserialize_cut(json.loads(json.dumps(dict(line, type="MultiCut"))))
    assert type(multi).__name__ == "MultiCut"
    assert isinstance(P.deserialize_cut(mixed.to_dict()), MixedCut)
    assert isinstance(P.deserialize_cut(line), MonoCut)
    assert isinstance(Recording.from_dict(cuts[0].perturb_speed(1.1).recording.to_dict()), Recording)
