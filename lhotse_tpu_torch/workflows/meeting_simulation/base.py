"""
Multi-speaker meeting simulation from single-utterance cuts (copied from
``lhotse_tpu/workflows/meeting_simulation/base.py``): the simulators' base
class, ``MeetingSampler`` (one ``DynamicCutSampler`` per speaker) and
``reverberate_cuts``.
"""
import abc
import random
from itertools import groupby
from typing import List, Optional, Union

import numpy as np

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.sampling import DynamicCutSampler
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import fastcopy

MAX_TASKS_WAITING = 1000


class BaseMeetingSimulator(abc.ABC):
    """
    Base for meeting simulators: ``fit()`` learns turn-taking/pause/overlap
    statistics from a SupervisionSet; ``simulate()`` turns a MonoCut CutSet
    into MixedCuts (one track per speaker); ``reverberate()`` convolves each
    track with a (possibly synthetic) RIR.
    """

    def __init__(self):
        if type(self) is BaseMeetingSimulator:
            raise TypeError(
                "BaseMeetingSimulator is an abstract base class and should not "
                "be instantiated."
            )

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    @abc.abstractmethod
    def fit(self, meetings: Optional[SupervisionSet] = None) -> None:
        """Learn the meeting parameter distributions from a dataset."""
        ...

    @abc.abstractmethod
    def simulate(
        self, cuts: CutSet, num_meetings: Optional[int] = None, num_repeats: Optional[int] = None,
    ) -> CutSet:
        """Simulate the desired number of multi-speaker meetings."""
        ...

    @abc.abstractmethod
    def reverberate(self, cuts: CutSet, *rirs: RecordingSet) -> CutSet:
        """Apply a reverberation effect to each track."""
        ...


class MeetingSampler:
    """
    Samples utterance groups for one meeting at a time: cuts are bucketed by
    speaker (one DynamicCutSampler per speaker); each meeting draws a speaker
    count, then a batch of utterances per chosen speaker.
    """

    def __init__(
        self, cuts: CutSet, num_repeats: Optional[int] = None, num_meetings: Optional[int] = None,
        num_speakers_per_meeting: Union[int, List[int]] = 2,
        speaker_count_probs: Optional[List[float]] = None,
        max_duration_per_speaker: Optional[float] = 20.0,
        max_utterances_per_speaker: Optional[int] = 5, seed: int = 0):
        if min(num_speakers_per_meeting) <= 1:
            raise AssertionError(
                "The number of speakers per meeting must be greater than 1. "
                f"Got: {num_speakers_per_meeting}"
            )
        if min(speaker_count_probs) <= 0.0:
            raise AssertionError(
                "The probabilities of the number of speakers per meeting must "
                f"be greater than 0. Got: {speaker_count_probs}"
            )
        if abs(sum(speaker_count_probs) - 1.0) >= 1e-8:
            raise AssertionError(
                "The probabilities of the number of speakers per meeting must "
                f"sum to 1. Got: {speaker_count_probs}"
            )
        if len(num_speakers_per_meeting) != len(speaker_count_probs):
            raise AssertionError(
                "The number of speakers per meeting and the number of "
                "probabilities must be the same."
            )

        # Dict for O(1) removal + sampling of speaker buckets.
        self.samplers = {}
        for spk, spk_cuts in groupby(
            sorted(cuts, key=lambda cut: cut.supervisions[0].speaker),
            lambda cut: cut.supervisions[0].speaker):
            sampler = DynamicCutSampler(
                CutSet.from_cuts(list(spk_cuts)).repeat( times=num_repeats, preserve_id=False ),
                max_duration=max_duration_per_speaker, max_cuts=max_utterances_per_speaker,
                shuffle=True, seed=seed, world_size=1, rank=0)
            self.samplers[spk] = sampler

        self.num_speakers_per_meeting = num_speakers_per_meeting
        self.speaker_count_probs = speaker_count_probs
        self.npr = np.random.RandomState(seed)
        self.rng = random.Random(seed)
        self._remaining_meetings = num_meetings

    def __iter__(self):
        for sampler in self.samplers.values():
            iter(sampler)
        return self

    def _draw_speaker_count(self) -> int:
        wanted = self.npr.choice(self.num_speakers_per_meeting, p=self.speaker_count_probs)
        return min(wanted, len(self.samplers))

    def __next__(self):
        if self._remaining_meetings == 0:
            raise StopIteration()
        if len(self.samplers) < min(self.num_speakers_per_meeting):
            raise StopIteration()

        # Sample the speaker count, then one batch per chosen speaker.
        chosen = self.rng.sample(sorted(self.samplers), self._draw_speaker_count())
        utterances = CutSet.from_cuts([])
        for spk_id in chosen:
            try:
                utterances = utterances + next(self.samplers[spk_id])
            except StopIteration:
                # This speaker's pool ran dry; retire it.
                del self.samplers[spk_id]

        utterances = utterances.to_eager().shuffle(rng=self.rng)
        if self._remaining_meetings is not None:
            self._remaining_meetings -= 1
        return utterances if len(utterances) > 0 else next(self)


def reverberate_cuts(cuts: CutSet, *rirs: RecordingSet) -> CutSet:
    """
    Convolve each track of the input MixedCuts with an RIR: a random RIR
    group with as many recordings as tracks when available, otherwise the
    fast random RIR approximation (arXiv:2208.04101).
    """
    rng = random.Random(0)
    out_cuts = []
    rir_groups = [list(g) for g in rirs]
    max_sources = max((len(g) for g in rir_groups), default=0)
    for cut in cuts:
        num_speakers = len(cut.tracks)
        matching = [g for g in rir_groups if len(g) == num_speakers]
        if num_speakers <= max_sources and matching:
            rir_group = rng.choice(matching)
            tracks = []
            for track, rir in zip(cut.tracks, rir_group):
                tracks.append(fastcopy(track, cut=track.cut.reverb_rir(rir)))
            out_cuts.append(fastcopy(cut, tracks=tracks))
        else:
            # Fast random approximation RIRs.
            out_cuts.append(cut.reverb_rir())

    return CutSet.from_cuts(out_cuts)
