"""
Conversational meeting simulation (BUT EEND-dataprep style), copied from
``lhotse_tpu/workflows/meeting_simulation/conversational.py``.
Method from arXiv:2204.00890: pause/overlap durations are drawn jointly for
all speakers from three learned histograms (same-speaker pause,
different-speaker pause, different-speaker overlap), producing realistic
overlap statistics. The draws come from numpy's global generator, as in the
JAX package: seed it (``fix_random_seed``) for a repeatable simulation.
"""
import logging
from collections import defaultdict
from functools import partial
from typing import Any, List, Optional, Union

import numpy as np

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet, MixedCut, MixTrack
from lhotse_tpu_torch.cut.set import mix
from lhotse_tpu_torch.lazy import dill_enabled
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import add_durations, uuid4
from lhotse_tpu_torch.workflows.meeting_simulation.base import (
    MAX_TASKS_WAITING, BaseMeetingSimulator, MeetingSampler, reverberate_cuts)


class ConversationalMeetingSimulator(BaseMeetingSimulator):
    """
    Samples pauses/overlaps from three distributions (learned histograms or
    Gamma defaults) so the simulated meetings match real speech/silence/
    overlap characteristics.
    """

    def __init__(
        self, same_spk_pause: float = 1.0, diff_spk_pause: float = 1.0,
        diff_spk_overlap: float = 2.0, prob_diff_spk_overlap: float = 0.5):
        super().__init__()
        for duration in (same_spk_pause, diff_spk_pause, diff_spk_overlap):
            assert duration is None or duration > 0, "Durations must be > 0."
        self.same_spk_pause, self.diff_spk_pause = same_spk_pause, diff_spk_pause
        self.diff_spk_overlap = diff_spk_overlap
        self.prob_diff_spk_overlap = prob_diff_spk_overlap

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__} "
            f"(same_spk_pause={self.same_spk_pause:.2f}, "
            f"diff_spk_pause={self.diff_spk_pause:.2f}, "
            f"diff_spk_overlap={self.diff_spk_overlap:.2f}, "
            f"prob_diff_spk_overlap={self.prob_diff_spk_overlap:.2f})"
        )

    def _init_defaults(self):
        from scipy.stats import gamma

        for attr in ("same_spk_pause", "diff_spk_pause", "diff_spk_overlap"):
            dist = gamma(a=1.0, scale=1.0, loc=getattr(self, attr))
            setattr(self, f"{attr}_dist", dist)

    def _compute_histogram_dist(self, values: np.ndarray) -> Any:
        from scipy.stats import rv_histogram, uniform

        values = np.asarray(values, dtype=np.float64)
        if values.max() - values.min() < 1e-6:
            # Numerically identical observations (e.g. a uniformly segmented
            # corpus): 100 bins over a ~1e-16 span produce zero-width bins
            # whose density normalization yields NaN samples. Degenerate to
            # the constant itself.
            return uniform(loc=float(values.mean()), scale=0.0)
        return rv_histogram(np.histogram(values, bins=100, density=True))

    @dill_enabled(True)
    def fit(self, meetings: Optional[SupervisionSet] = None) -> None:
        """Fit the three pause/overlap histograms to a real corpus."""
        if meetings is None:
            logging.info("No meetings provided, using default parameters.")
            self._init_defaults()
            return

        assert isinstance(meetings, SupervisionSet), (
            "The meetings must be provided as a SupervisionSet."
        )

        gaps = {"same_spk_pause": [], "diff_spk_pause": [], "diff_spk_overlap": []}

        by_recording = defaultdict(list)
        for s in sorted(meetings, key=lambda s: (s.recording_id, s.start)):
            by_recording[s.recording_id].append(s)

        for segments in by_recording.values():
            for prev, cur in zip(segments, segments[1:]):
                step = cur.start - prev.end
                if cur.speaker == prev.speaker:
                    gaps["same_spk_pause"].append(step)
                elif step > 0:
                    gaps["diff_spk_pause"].append(step)
                else:
                    gaps["diff_spk_overlap"].append(-step)

        from scipy.stats import gamma

        for attr, values in gaps.items():
            if len(values) == 0:
                # A category the corpus never exhibits (e.g. no overlaps):
                # an empty histogram would sample NaN durations. Keep the
                # default prior for it instead.
                logging.info(
                    f"No '{attr}' observations in the fitted corpus; keeping "
                    f"the default distribution."
                )
                setattr(self, f"{attr}_dist", gamma(a=1.0, scale=1.0, loc=getattr(self, attr)))
                continue
            dist = self._compute_histogram_dist(np.array(values))
            setattr(self, f"{attr}_dist", dist)
            # Empirical mean, not dist.mean(): the degenerate uniform
            # (scale=0) distribution reports mean() as NaN in scipy.
            setattr(self, attr, float(np.mean(values)))
        turn_changes = len(gaps["diff_spk_pause"]) + len(gaps["diff_spk_overlap"])
        self.prob_diff_spk_overlap = (
            len(gaps["diff_spk_overlap"]) / turn_changes if turn_changes else 0.5
        )

        logging.info(f"Learned parameters: {self}")

    def _create_mixture(self, utterances: CutSet, allow_3fold_overlap: bool = False) -> MixedCut:
        """
        Chain the sampled utterances with pauses/overlaps drawn from the
        learned distributions, then group per speaker into MixTracks.
        """
        utts = list(utterances)
        sr = utts[0].sampling_rate
        N = len(utts)
        draws = {
            "same_pause": self.same_spk_pause_dist.rvs(size=N).round(2),
            "diff_pause": self.diff_spk_pause_dist.rvs(size=N).round(2),
            "overlap": self.diff_spk_overlap_dist.rvs(size=N).round(2),
            "do_overlap": self.bernoulli.rvs(p=self.prob_diff_spk_overlap, size=N)}

        def spk_of(utt):
            return utt.supervisions[0].speaker

        plus = lambda *xs: add_durations(*xs, sampling_rate=sr)

        # Offsets w.r.t. the meeting start: each new utterance starts after a
        # sampled pause (or before the previous one ends, for overlaps).
        offsets = [0.0]
        frontier = plus(utts[0].duration)
        spk_end = {spkr: 0.0 for spkr in utterances.speakers}
        spk_end[spk_of(utts[0])] = frontier

        for i in range(1, N):
            cur_spk, prev_spk = spk_of(utts[i]), spk_of(utts[i - 1])
            if cur_spk == prev_spk:
                step = draws["same_pause"][i]
            elif not draws["do_overlap"][i]:
                step = draws["diff_pause"][i]
            else:
                # Overlap, but never with the same speaker's own audio; and
                # (unless allowed) never three speakers at once.
                caps = [plus(frontier, -spk_end[cur_spk])]
                ends_desc = sorted(spk_end.values(), reverse=True)
                if len(ends_desc) > 1 and not allow_3fold_overlap:
                    caps.append(plus(frontier, -ends_desc[1]))
                step = -min(draws["overlap"][i], *caps)

            begin = plus(frontier, step)
            offsets.append(begin)
            spk_end[cur_spk] = plus(begin, utts[i].duration)
            frontier = max(spk_end.values())

        # Group utterances + offsets per speaker (sorted by offset).
        per_speaker = defaultdict(list)
        for utt, offset in sorted(zip(utts, offsets), key=lambda pair: pair[1]):
            per_speaker[spk_of(utt)].append((utt, offset))

        tracks = []
        for spk_utts in per_speaker.values():
            track, start = spk_utts[0]
            for utt, offset in spk_utts[1:]:
                track = mix(track, utt, offset=plus(offset, -start), allow_padding=True)
            tracks.append(MixTrack(cut=track, offset=start))

        tracks.sort(key=lambda t: t.offset)
        return MixedCut(id=str(uuid4()), tracks=tracks)

    @dill_enabled(True)
    def simulate(
        self, cuts: CutSet, num_meetings: Optional[int] = None, num_repeats: Optional[int] = None,
        num_speakers_per_meeting: Union[int, List[int]] = 2,
        speaker_count_probs: Optional[List[float]] = None,
        max_duration_per_speaker: Optional[float] = 20.0,
        max_utterances_per_speaker: Optional[int] = 5, allow_3fold_overlap: bool = False,
        seed: int = 0, num_jobs: int = 1) -> CutSet:
        """
        Simulate meetings (see SpeakerIndependentMeetingSimulator.simulate
        for parameter semantics; ``allow_3fold_overlap`` permits 3+ speakers
        talking at once).
        """
        from scipy.stats import bernoulli

        if num_meetings is None and num_repeats is None:
            raise ValueError("Either num_meetings or num_repeats must be provided.")
        if num_meetings is not None:
            num_repeats = None
        if isinstance(num_speakers_per_meeting, int):
            num_speakers_per_meeting = [num_speakers_per_meeting]
        if speaker_count_probs is None:
            uniform = 1.0 / len(num_speakers_per_meeting)
            speaker_count_probs = [uniform] * len(num_speakers_per_meeting)
        if getattr(self, "same_spk_pause_dist", None) is None:
            self._init_defaults()
        self.bernoulli = bernoulli

        sampler = MeetingSampler(
            cuts, num_repeats=num_repeats, num_meetings=num_meetings,
            max_duration_per_speaker=max_duration_per_speaker,
            max_utterances_per_speaker=max_utterances_per_speaker,
            num_speakers_per_meeting=num_speakers_per_meeting,
            speaker_count_probs=speaker_count_probs, seed=seed)
        work = partial(_simulate_worker, simulator=self, allow_3fold_overlap=allow_3fold_overlap)
        if num_jobs == 1:
            mixtures = map(work, iter(sampler))
        else:
            mixtures = parallel_map(
                work, iter(sampler), num_jobs=num_jobs, queue_size=num_jobs * MAX_TASKS_WAITING)
        return CutSet.from_cuts(list(mixtures))

    def reverberate(self, cuts: CutSet, *rirs: RecordingSet) -> CutSet:
        return reverberate_cuts(cuts, *rirs)


def _simulate_worker(
    utterances, allow_3fold_overlap: bool, simulator: ConversationalMeetingSimulator):
    return simulator._create_mixture(utterances, allow_3fold_overlap=allow_3fold_overlap)
