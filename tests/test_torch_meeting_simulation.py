"""
The port's meeting simulation (``lhotse_tpu_torch/workflows``) held to the
JAX package's (``lhotse_tpu/workflows/meeting_simulation``): every case of
``tests/test_meeting_simulation.py`` runs through both packages on the same
seeded inputs, each side after its own ``fix_random_seed`` (the
conversational simulator draws from numpy's global generator, and both name
mixtures with ``uuid4``). Simulated ``MixedCut``s must be equal as
``to_dict()`` and their mixed audio ``np.array_equal``. Also: the fitted
statistics on overlapping and on degenerate corpora, ``reverberate_cuts``
with RIR groups and with the fast random RIRs, and the invariants of
``simulate(num_jobs=2)``, whose spawned workers take meetings in no fixed
order.
"""
import warnings

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.testing import dummies as jdummies
from lhotse_tpu.utils import fix_random_seed as jax_seed
from lhotse_tpu.workflows import meeting_simulation as jsim
from lhotse_tpu_torch import supervision as psup
from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.testing import dummies as pdummies
from lhotse_tpu_torch.utils import fix_random_seed as port_seed
from lhotse_tpu_torch.workflows import meeting_simulation as psim

SR = 16000
SIMULATORS = ["SpeakerIndependentMeetingSimulator", "ConversationalMeetingSimulator"]


class _Side:
    """One package's names."""

    def __init__(self, jax: bool):
        self.jax = jax
        self.sim = jsim if jax else psim
        self.dummies = jdummies if jax else pdummies
        self.CutSet = J.CutSet if jax else CutSet
        self.Recording = J.Recording if jax else Recording
        self.RecordingSet = J.RecordingSet if jax else RecordingSet
        self.SupervisionSegment = J.SupervisionSegment if jax else psup.SupervisionSegment
        self.SupervisionSet = J.SupervisionSet if jax else psup.SupervisionSet
        self.seed = jax_seed if jax else port_seed


JAX, PORT = _Side(True), _Side(False)


def _utterances(side):
    cuts = []
    for i in range(12):
        c = side.dummies.dummy_cut(
            i, with_data=True, supervisions=[side.dummies.dummy_supervision(i, duration=1.0)])
        c.supervisions[0].speaker = f"spk{i % 4}"
        c.custom = {}
        cuts.append(c)
    return side.CutSet.from_cuts(cuts)


def _uniform_meeting_sups(side):
    """Every inter-segment gap numerically identical and no overlaps."""
    return side.SupervisionSet.from_segments([
        side.SupervisionSegment(id=f"m{i}", recording_id="meet0", start=i * 1.3, duration=1.0,
                                channel=0, speaker=f"s{i % 2}")
        for i in range(20)])


def _overlapping_sups(side):
    sups, t = [], 0.0
    for i in range(30):
        # Alternate speakers with a mix of pauses and overlaps.
        start = max(t + (0.4 if i % 3 else -0.2), 0.0)
        sups.append(side.SupervisionSegment(
            id=f"m{i}", recording_id="meet0", start=round(start, 2), duration=1.0, channel=0,
            speaker=f"s{i % 2}"))
        t = start + 1.0
    return side.SupervisionSet.from_segments(sups)


def _both(run, seed=0):
    """``run(side)`` for each package after its own seed; returns (jax, port)."""
    out = []
    for side in (JAX, PORT):
        side.seed(seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append(run(side))
    return out


def _assert_same_meetings(theirs, ours):
    theirs, ours = list(theirs), list(ours)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(theirs, ours):
        assert b.to_dict() == a.to_dict()
        audio = b.load_audio()
        assert np.isfinite(audio).all()
        assert np.array_equal(audio, a.load_audio())


@pytest.mark.parametrize("name", SIMULATORS)
def test_simulate_without_fit(name):
    def run(side):
        sim = getattr(side.sim, name)()
        return list(sim.simulate(_utterances(side), num_meetings=3, num_speakers_per_meeting=2,
                                 seed=5))

    theirs, ours = _both(run)
    _assert_same_meetings(theirs, ours)
    for m in ours:
        assert len({s.speaker for s in m.supervisions}) == 2


@pytest.mark.parametrize("name", SIMULATORS)
def test_fit_on_degenerate_corpus_still_simulates(name):
    def run(side):
        sim = getattr(side.sim, name)()
        sim.fit(_uniform_meeting_sups(side))
        return repr(sim), list(sim.simulate(_utterances(side), num_meetings=3,
                                            num_speakers_per_meeting=2, seed=5))

    (jrepr, theirs), (prepr, ours) = _both(run)
    assert prepr == jrepr
    _assert_same_meetings(theirs, ours)
    assert all(np.isfinite(m.duration) for m in ours)


def test_conversational_fit_learns_overlap_probability():
    def run(side):
        sim = side.sim.ConversationalMeetingSimulator()
        sim.fit(_overlapping_sups(side))
        stats = (sim.same_spk_pause, sim.diff_spk_pause, sim.diff_spk_overlap,
                 sim.prob_diff_spk_overlap)
        return stats, list(sim.simulate(_utterances(side), num_meetings=2,
                                        num_speakers_per_meeting=2, seed=1))

    (jstats, theirs), (pstats, ours) = _both(run)
    assert pstats == jstats
    assert 0.0 < pstats[3] < 1.0
    _assert_same_meetings(theirs, ours)


@pytest.mark.parametrize("corpus", ["overlapping", "degenerate"])
def test_conversational_fit_statistics(corpus):
    """The fitted histograms draw the same pauses and overlaps; on the
    degenerate corpus the empty overlap category keeps its default prior."""
    make = _overlapping_sups if corpus == "overlapping" else _uniform_meeting_sups

    def run(side):
        sim = side.sim.ConversationalMeetingSimulator()
        sim.fit(make(side))
        draws = [getattr(sim, f"{attr}_dist").rvs(size=16)
                 for attr in ("same_spk_pause", "diff_spk_pause", "diff_spk_overlap")]
        return repr(sim), type(sim.diff_spk_overlap_dist.dist).__name__, draws

    (jrepr, jkind, jdraws), (prepr, pkind, pdraws) = _both(run, seed=11)
    assert (prepr, pkind) == (jrepr, jkind)
    for a, b in zip(jdraws, pdraws):
        assert np.array_equal(a, b) and np.isfinite(b).all()
    if corpus == "degenerate":
        assert pkind == "gamma_gen"


def test_speaker_independent_fit_on_identical_gaps(tmp_path):
    """scipy's expon MLE gives a tiny negative scale for identical gaps; the
    fitted scale is clamped to >= 0 in both packages."""
    for i in range(6):
        write_wav(str(tmp_path / f"u{i}.wav"), (0.05 * np.ones(SR)).astype(np.float32), SR)

    def run(side):
        cuts = []
        for i in range(6):
            c = side.Recording.from_file(tmp_path / f"u{i}.wav", recording_id=f"u{i}").to_cut()
            c.supervisions = [side.SupervisionSegment(
                id=f"s{i}", recording_id=f"u{i}", start=0, duration=1.0, speaker=f"spk{i % 3}")]
            cuts.append(c)
        meetings = side.SupervisionSet.from_segments([
            side.SupervisionSegment(id=f"m{m}-{k}", recording_id=f"meet{m}", start=k * 3.0,
                                    duration=1.0, speaker="one-speaker")
            for m in range(2) for k in range(3)])
        sim = side.sim.SpeakerIndependentMeetingSimulator()
        sim.fit(meetings)
        return (sim.loc, sim.scale), list(sim.simulate(
            side.CutSet.from_cuts(cuts), num_meetings=2, num_speakers_per_meeting=2, seed=3))

    (jfit, theirs), (pfit, ours) = _both(run)
    assert pfit == jfit and pfit[1] >= 0.0
    _assert_same_meetings(theirs, ours)


@pytest.fixture(scope="module")
def rir_dir(tmp_path_factory):
    """Numpy-seeded decaying-noise RIRs: a group of 2 and a group of 3."""
    d = tmp_path_factory.mktemp("rirs")
    rng = np.random.RandomState(7)
    t = np.arange(SR // 4, dtype=np.float32)
    for i in range(5):
        rir = (rng.standard_normal(t.size) * np.exp(-t / 800.0)).astype(np.float32)
        rir[0] = 1.0
        write_wav(str(d / f"rir{i}.wav"), 0.5 * rir / np.abs(rir).max(), SR)
    return d


@pytest.mark.parametrize("groups", ["rir_groups", "fast_random"])
@pytest.mark.parametrize("name", SIMULATORS)
def test_reverberate(rir_dir, groups, name):
    """Meetings of 2 and 3 speakers: with RIR groups of 2 and 3 recordings
    each track takes one RIR of the matching group; with none, the fast
    random RIRs under the fixed seed."""
    def run(side):
        sim = getattr(side.sim, name)()
        meetings = sim.simulate(_utterances(side), num_meetings=4,
                                num_speakers_per_meeting=[2, 3], seed=2)
        rirs = []
        if groups == "rir_groups":
            recs = [side.Recording.from_file(rir_dir / f"rir{i}.wav") for i in range(5)]
            rirs = [side.RecordingSet.from_recordings(recs[:2]),
                    side.RecordingSet.from_recordings(recs[2:])]
        return list(sim.reverberate(meetings, *rirs))

    theirs, ours = _both(run)
    _assert_same_meetings(theirs, ours)
    assert {len(m.tracks) for m in ours} == {2, 3}
    if groups == "rir_groups":
        for m in ours:
            # A track is one speaker's utterances; all of them take its RIR.
            per_track = [_rir_ids(t.cut.to_dict()) for t in m.tracks]
            assert all(len(ids) == 1 for ids in per_track)
            assert sorted(ids.pop() for ids in per_track) == (
                [f"rir{i}" for i in range(2)] if len(m.tracks) == 2
                else [f"rir{i}" for i in range(2, 5)])


def _rir_ids(node) -> set:
    if isinstance(node, dict):
        found = {node["kwargs"]["rir"]["id"]} if node.get("name") == "ReverbWithImpulseResponse" \
            else set()
        return found.union(*(_rir_ids(v) for v in node.values()))
    if isinstance(node, list):
        return set().union(*(_rir_ids(v) for v in node))
    return set()


@pytest.mark.parametrize("name", SIMULATORS)
def test_simulate_two_spawned_jobs(name):
    """``num_jobs=2`` hands meetings to two spawned processes: the same
    number of meetings as one job, each meeting's speakers' utterances kept,
    no NaN offset."""
    utterances = _utterances(PORT)
    sim = getattr(psim, name)()
    port_seed(0)
    one = sim.simulate(utterances, num_repeats=1, num_speakers_per_meeting=[2, 3], seed=4)
    two = sim.simulate(utterances, num_repeats=1, num_speakers_per_meeting=[2, 3], seed=4,
                       num_jobs=2)
    assert len(two) == len(one) > 0

    def sources(meetings):
        return sorted(sorted(s.id for s in m.supervisions) for m in meetings)

    assert sources(two) == sources(one)
    for m in two:
        assert all(np.isfinite(t.offset) for t in m.tracks)
        for t in m.tracks:
            assert len({s.speaker for s in t.cut.supervisions}) == 1


@pytest.mark.parametrize("keep", [False, True])
def test_windows_of_simulated_meetings(keep):
    """A meeting's speaker tracks are ``MixedCut``s themselves. The JAX
    package's windowing indexes one level of tracks and raises ``KeyError``
    on them; the port's windows equal the JAX package's truncations of each
    window without the index (dicts, audio and supervisions)."""
    def meetings(side):
        return side.sim.ConversationalMeetingSimulator().simulate(
            _utterances(side), num_meetings=3, num_speakers_per_meeting=[2, 3], seed=1)

    def run(side):
        cuts = meetings(side)
        if side.jax:
            with pytest.raises(KeyError):
                cuts.cut_into_windows(2.0, keep_excessive_supervisions=keep).to_eager()
            side.seed(0)
            cuts = meetings(side)
            return [m.truncate(offset=2.0 * i, duration=2.0, keep_excessive_supervisions=keep)
                    .with_id(f"{m.id}-{i}")
                    for m in cuts for i in range(int(np.ceil(m.duration / 2.0)))]
        side.seed(0)
        cuts = meetings(side)
        return list(cuts.cut_into_windows(2.0, keep_excessive_supervisions=keep))

    theirs, ours = _both(run)
    _assert_same_meetings(theirs, ours)
    assert sum(len(w.supervisions) for w in ours) > 0
