"""
Energy voice activity detection over recordings (copied from
``lhotse_tpu/workflows/activity_detection/energy.py``): host numpy in
float64, no model; frames whose RMS exceeds a fraction of the peak are
speech.
"""
from typing import List, Tuple

import numpy as np

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet


def _energy_spans(
    track: np.ndarray, sampling_rate: int, duration: float, threshold: float = 0.01,
    min_duration: float = 0.25, min_pause: float = 0.15, frame_size: float = 0.025,
    frame_shift: float = 0.010,
) -> List[Tuple[float, float]]:
    """
    Frame-RMS voice activity detection on one track: frames whose RMS
    exceeds ``threshold × max_rms`` are speech; runs shorter than
    ``min_duration`` are dropped and gaps shorter than ``min_pause`` merged.
    Returns ``(start, duration)`` spans in seconds, rounded to 3 digits and
    clipped to ``duration``.
    """
    flen = int(frame_size * sampling_rate)
    fshift = int(frame_shift * sampling_rate)
    if len(track) < flen:
        return []

    n_frames = 1 + (len(track) - flen) // fshift
    strided = np.lib.stride_tricks.as_strided(
        track, shape=(n_frames, flen), strides=(track.strides[0] * fshift, track.strides[0]))
    rms = np.sqrt((strided.astype(np.float64) ** 2).mean(axis=1))
    peak = rms.max()
    if peak <= 0:
        return []
    active = rms > threshold * peak

    # Active frames → (start, end) second spans.
    spans = []
    start = None
    for i, a in enumerate(active):
        t = i * frame_shift
        if a and start is None:
            start = t
        elif not a and start is not None:
            spans.append((start, t + frame_size))
            start = None
    if start is not None:
        spans.append((start, (n_frames - 1) * frame_shift + frame_size))

    # Merge close spans, drop short ones.
    merged = []
    for s, e in spans:
        if merged and s - merged[-1][1] < min_pause:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return [(round(s, 3), round(min(e, duration) - s, 3)) for s, e in merged
            if e - s >= min_duration]


def detect_activity_energy_single(
    recording: Recording, threshold: float = 0.01, min_duration: float = 0.25,
    min_pause: float = 0.15, frame_size: float = 0.025, frame_shift: float = 0.010,
) -> List[SupervisionSegment]:
    """:func:`_energy_spans` of a recording's first channel as supervisions."""
    spans = _energy_spans(
        recording.load_audio()[0], recording.sampling_rate, recording.duration,
        threshold=threshold, min_duration=min_duration, min_pause=min_pause,
        frame_size=frame_size, frame_shift=frame_shift)
    return [
        SupervisionSegment(
            id=f"{recording.id}-vad-{i:04d}", recording_id=recording.id, start=start,
            duration=duration, channel=0)
        for i, (start, duration) in enumerate(spans)]


def detect_activity_energy(
    recordings: RecordingSet, threshold: float = 0.01, min_duration: float = 0.25,
    num_jobs: int = 1) -> SupervisionSet:
    """Run energy VAD over a RecordingSet (optionally in parallel)."""
    from functools import partial

    work = partial(detect_activity_energy_single, threshold=threshold, min_duration=min_duration)
    segments = []
    if num_jobs == 1:
        for r in recordings:
            segments.extend(work(r))
    else:
        for segs in parallel_map(work, recordings, num_jobs=num_jobs):
            segments.extend(segs)
    return SupervisionSet.from_segments(segments)
