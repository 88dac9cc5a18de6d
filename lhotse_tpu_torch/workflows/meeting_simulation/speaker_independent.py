"""
EEND-style speaker-independent meeting simulation, copied from
``lhotse_tpu/workflows/meeting_simulation/speaker_independent.py``.
Method from arXiv:1909.06247 (Algorithm 1): per-speaker channels built by
concatenating utterances with exponential pauses, then mixed. Each meeting's
pauses come from a fresh ``RandomState(seed)``, as in the JAX package.
"""
import logging
from collections import defaultdict
from functools import partial
from typing import List, Optional, Union

import numpy as np

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet, MixedCut, MixTrack
from lhotse_tpu_torch.cut.set import mix
from lhotse_tpu_torch.lazy import dill_enabled
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import uuid4
from lhotse_tpu_torch.workflows.meeting_simulation.base import (
    MAX_TASKS_WAITING, BaseMeetingSimulator, MeetingSampler, reverberate_cuts)


class SpeakerIndependentMeetingSimulator(BaseMeetingSimulator):
    """
    Simulates each speaker channel independently with exponential inter-
    utterance pauses (loc = minimum silence, scale = exponential scale);
    independent channels can produce more overlap than real meetings.
    """

    def __init__(self, loc: float = 0.0, scale: float = 2.0):
        super().__init__()
        self.loc = loc
        self.scale = scale

    def __repr__(self):
        return self.__class__.__name__ + f"(loc={self.loc}, scale={self.scale})"

    @dill_enabled(True)
    def fit(self, meetings: Optional[SupervisionSet] = None) -> None:
        """Fit the exponential pause distribution to a real corpus."""
        if meetings is None:
            logging.info(
                f"No meetings provided, using default parameters: "
                f"loc={self.loc}, scale={self.scale}"
            )
            return

        assert isinstance(meetings, SupervisionSet), (
            "The meetings must be provided as a SupervisionSet."
        )

        from scipy.stats import expon

        per_speaker = defaultdict(list)
        for s in meetings:
            per_speaker[(s.recording_id, s.speaker)].append(s)

        gaps = []
        for segments in per_speaker.values():
            segments.sort(key=lambda s: s.start)
            gaps.extend(max(0, nxt.start - prev.end) for prev, nxt in zip(segments, segments[1:]))

        if not gaps:
            # No speaker has two utterances in any meeting: nothing to fit;
            # expon.fit([]) would return NaN parameters.
            logging.info(
                "No same-speaker gaps in the fitted corpus; keeping default "
                f"parameters: loc={self.loc}, scale={self.scale}"
            )
            return
        self.loc, self.scale = expon.fit(gaps)
        # Identical gap values make scipy's MLE return a *tiny negative*
        # scale (~-4e-16 float error), which np.random.exponential rejects.
        self.scale = max(self.scale, 0.0)
        logging.info(f"Learned parameters: loc={self.loc:.2f}, scale={self.scale:.2f}")

    def _create_mixture(
        self, utterances: List[CutSet], silence_durations: List[np.ndarray]) -> MixedCut:
        """One track per speaker: utterances chained with sampled pauses."""
        def chain(utts, pauses):
            merged = utts[0]
            for pause, utt in zip(pauses[1:], utts[1:]):
                merged = mix(merged, utt, offset=merged.duration + pause, allow_padding=True)
            return merged

        tracks = [
            MixTrack(
                cut=chain(list(utts), pauses),
                # The first track must have offset 0.0.
                offset=0 if i == 0 else float(pauses[0]),
            )
            for i, (utts, pauses) in enumerate(zip(utterances, silence_durations))
        ]
        return MixedCut(id=str(uuid4()), tracks=tracks)

    @dill_enabled(True)
    def simulate(
        self, cuts: CutSet, num_meetings: Optional[int] = None, num_repeats: Optional[int] = None,
        num_speakers_per_meeting: Union[int, List[int]] = 2,
        speaker_count_probs: Optional[List[float]] = None,
        max_duration_per_speaker: Optional[float] = 20.0,
        max_utterances_per_speaker: Optional[int] = 5, seed: int = 0, num_jobs: int = 1) -> CutSet:
        """
        Simulate meetings; supply either ``num_meetings`` or ``num_repeats``
        (how many times each source cut may be reused).
        """
        if num_meetings is None and num_repeats is None:
            raise ValueError("Either num_meetings or num_repeats must be provided.")

        if num_meetings is not None:
            num_repeats = None

        if isinstance(num_speakers_per_meeting, int):
            num_speakers_per_meeting = [num_speakers_per_meeting]

        if speaker_count_probs is None:
            speaker_count_probs = [1.0 / len(num_speakers_per_meeting)] * len(
                num_speakers_per_meeting
            )

        sampler = MeetingSampler(
            cuts, num_repeats=num_repeats, num_meetings=num_meetings,
            max_duration_per_speaker=max_duration_per_speaker,
            max_utterances_per_speaker=max_utterances_per_speaker,
            num_speakers_per_meeting=num_speakers_per_meeting,
            speaker_count_probs=speaker_count_probs, seed=seed)
        work = partial(_simulate_worker, seed=seed, simulator=self)
        if num_jobs == 1:
            mixtures = map(work, iter(sampler))
        else:
            mixtures = parallel_map(
                work, iter(sampler), num_jobs=num_jobs, queue_size=num_jobs * MAX_TASKS_WAITING)
        return CutSet.from_cuts(list(mixtures))

    def reverberate(self, cuts: CutSet, *rirs: RecordingSet) -> CutSet:
        return reverberate_cuts(cuts, *rirs)


def _simulate_worker(
    utterances: CutSet, seed: int, simulator: SpeakerIndependentMeetingSimulator) -> MixedCut:
    npr = np.random.RandomState(seed)

    by_speaker = defaultdict(list)
    for utt in utterances:
        by_speaker[utt.supervisions[0].speaker].append(utt)
    per_speaker = [CutSet.from_cuts(group) for group in by_speaker.values()]

    silence_durations = [
        simulator.loc + npr.exponential(scale=simulator.scale, size=len(group))
        for group in per_speaker
    ]

    return simulator._create_mixture(per_speaker, silence_durations)
