"""
Dataset overview statistics (copied from ``lhotse_tpu/cut/describe.py``):
``CutSetStatistics`` behind ``CutSet.describe()`` (an accumulator that
combines across workers, with the speech, silence and overlap breakdown and,
with ``full=True``, the per-speaker-count table), and the speaker-count
interval sweep ``find_segments_with_speaker_count`` that
``trim_to_unsupervised_segments`` uses. Tables use ``tabulate`` when it is
installed and a plain column layout otherwise.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from copy import deepcopy
from math import ceil
from typing import List, Optional, Tuple

import numpy as np

from lhotse_tpu_torch.utils import Seconds, TimeSpan, ifnone, is_module_available

_QUANTILE_ROWS: Tuple[Tuple[str, float], ...] = (
    ("mean", -1.0),  # sentinel handled specially
    ("std", -2.0),
    ("min", 0.0),
    ("25%", 25.0),
    ("50%", 50.0),
    ("75%", 75.0),
    ("99%", 99.0),
    ("99.5%", 99.5),
    ("99.9%", 99.9),
    ("max", 100.0),
)


def _hms(seconds: Seconds) -> str:
    """Render seconds as hh:mm:ss, rounding the seconds field up."""
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{int(h):02d}:{int(m):02d}:{ceil(s):02d}"


def _render_table(rows, headers=None, tablefmt="fancy_grid") -> str:
    if is_module_available("tabulate"):
        from tabulate import tabulate

        if headers == "firstrow":
            return tabulate(rows, headers="firstrow", tablefmt=tablefmt)
        return tabulate(rows, tablefmt=tablefmt)
    # Minimal dependency-free rendering: left-justified columns.
    ncol = max(len(r) for r in rows)
    widths = [max(len(str(r[i])) for r in rows if len(r) > i) for i in range(ncol)]
    return "\n".join(" | ".join(str(v).ljust(w) for v, w in zip(r, widths)) for r in rows)


class CutSetStatistics:
    """
    Streaming accumulator behind ``CutSet.describe()``.

    Feed it cut sets with :meth:`accumulate` (possibly one instance per
    parallel worker), merge instances with :meth:`combine`, then render with
    :meth:`describe`.  With ``full=True`` it additionally tracks
    single-speaker vs overlapped speech and a per-speaker-count breakdown
    (overlap is resolved up to 4 concurrent speakers).
    """

    def __init__(self, full: bool = False):
        self.full = full
        self.counters = defaultdict(int)
        self.cut_custom, self.sup_custom = Counter(), Counter()
        self.cut_durations: List[float] = []
        self.speaking_time_durations: List[float] = []
        self.speech_durations: List[float] = []
        if full:
            self.durations_by_num_speakers = defaultdict(list)
            self.single_durations: List[float] = []
            self.overlapped_durations: List[float] = []

    # -- gathering -----------------------------------------------------------

    def accumulate(self, cuts) -> "CutSetStatistics":
        """Fold the statistics of every cut in ``cuts`` into this accumulator."""
        for cut in cuts:
            self._take_cut(cut)
        return self

    def _take_cut(self, cut) -> None:
        self.cut_durations.append(cut.duration)
        for key in ifnone(getattr(cut, "custom", None), ()):
            self.cut_custom[key] += 1
        self.counters["recordings"] += int(cut.has_recording)
        self.counters["features"] += int(cut.has_features)
        for sup in cut.trimmed_supervisions:
            self.counters["supervisions"] += 1
            self.speaking_time_durations.append(sup.duration)
            for key in ifnone(sup.custom, ()):
                self.sup_custom[key] += 1
        self.speech_durations.append(_covered_duration(cut, 1, None))
        if self.full:
            solo = _covered_duration(cut, 1, 1)
            self.single_durations.append(solo)
            self.overlapped_durations.append(_covered_duration(cut, 2, None))
            self.durations_by_num_speakers[1].append(solo)
            for k in (2, 3, 4):
                self.durations_by_num_speakers[k].append(_covered_duration(cut, k, k))

    def combine(self, *others: "CutSetStatistics") -> "CutSetStatistics":
        """Merge several accumulators into a new one; operands are unchanged."""
        merged = deepcopy(self)
        for o in others:
            if merged.full != o.full:
                raise ValueError(
                    "Refusing to combine CutSetStatistics with mismatched "
                    f"full= settings ({merged.full} vs {o.full})."
                )
            merged.counters = defaultdict(int, Counter(merged.counters) + Counter(o.counters))
            merged.cut_custom += o.cut_custom
            merged.sup_custom += o.sup_custom
            merged.cut_durations += o.cut_durations
            merged.speaking_time_durations += o.speaking_time_durations
            merged.speech_durations += o.speech_durations
            if merged.full:
                merged.single_durations += o.single_durations
                merged.overlapped_durations += o.overlapped_durations
                for k, v in o.durations_by_num_speakers.items():
                    merged.durations_by_num_speakers[k].extend(v)
        return merged

    # -- rendering -----------------------------------------------------------

    def describe(self) -> None:
        """Print the report to stdout."""
        print(self.render())

    def render(self) -> str:
        durs = np.asarray(self.cut_durations, dtype=np.float64)
        total = float(durs.sum())
        blocks = [self._cuts_block(durs, total)]
        if self.cut_custom:
            blocks.append(
                "CUT custom fields:\n"
                + "\n".join(f"- {k} (in {n} cuts)" for k, n in self.cut_custom.most_common())
            )
        if self.sup_custom:
            blocks.append(
                "SUPERVISION custom fields:\n"
                + "\n".join(f"- {k} (in {n} cuts)" for k, n in self.sup_custom.most_common())
            )
        blocks.append(self._speech_block(total))
        if self.full:
            blocks.append(self._per_speaker_block())
        return "\n".join(blocks)

    def _cuts_block(self, durs: np.ndarray, total: float) -> str:
        rows = [["Cuts count:", len(durs)], ["Total duration (hh:mm:ss)", _hms(total)]]
        for label, q in _QUANTILE_ROWS:
            if q == -1.0:
                val = durs.mean()
            elif q == -2.0:
                val = durs.std()
            else:
                val = np.percentile(durs, q)
            rows.append([label, f"{val:.1f}"])
        for name, count in self.counters.items():
            rows.append([f"{name.title()} available:", count])
        return "Cut statistics:\n" + _render_table(rows)

    def _speech_block(self, total: float) -> str:
        speech = float(np.sum(self.speech_durations))
        speaking = float(np.sum(self.speaking_time_durations))
        rows = [
            ["Total speech duration", _hms(speech), f"{speech / total:.2%} of recording"],
            [ "Total speaking time duration", _hms(speaking), f"{speaking / total:.2%} of recording", ],
            [ "Total silence duration", _hms(total - speech), f"{(total - speech) / total:.2%} of recording", ],
        ]
        if self.full:
            solo = float(np.sum(self.single_durations))
            lap = float(np.sum(self.overlapped_durations))
            rows.append(
                [
                    "Single-speaker duration",
                    _hms(solo),
                    f"{solo / total:.2%} ({solo / speech:.2%} of speech)",
                ]
            )
            rows.append(
                [
                    "Overlapped speech duration",
                    _hms(lap),
                    f"{lap / total:.2%} ({lap / speech:.2%} of speech)",
                ]
            )
        return "Speech duration statistics:\n" + _render_table(rows)

    def _per_speaker_block(self) -> str:
        speech = float(np.sum(self.speech_durations))
        speaking = float(np.sum(self.speaking_time_durations))
        rows = [
            [
                "Number of speakers",
                "Duration (hh:mm:ss)",
                "Speaking time (hh:mm:ss)",
                "% of speech",
                "% of speaking time",
            ]
        ]
        for nspk, dlist in self.durations_by_num_speakers.items():
            block = float(np.sum(dlist))
            rows.append(
                [
                    nspk,
                    _hms(block),
                    _hms(nspk * block),
                    f"{block / speech:.2%}",
                    f"{nspk * block / speaking:.2%}",
                ]
            )
        rows.append(["Total", _hms(speech), _hms(speaking), "100.00%", "100.00%"])
        return "Speech duration statistics by number of speakers:\n" + _render_table(
            rows, headers="firstrow")


def _covered_duration(cut, min_speakers: int, max_speakers: Optional[int]) -> float:
    return sum(
        span.duration
        for span in find_segments_with_speaker_count(cut, min_speakers, max_speakers)
    )


def find_segments_with_speaker_count(
    cut, min_speakers: int = 0, max_speakers: Optional[int] = None) -> List[TimeSpan]:
    """
    Return the maximal intervals of ``cut`` during which the number of
    simultaneously active supervisions lies in ``[min_speakers, max_speakers]``.

    Vectorized event-scan: supervision starts contribute +1 and ends -1 at
    their (cut-clamped) timestamps; a prefix sum over the sorted unique event
    times yields the concurrent-speaker count on each elementary interval.
    """
    hi = np.inf if max_speakers is None else max_speakers
    if not 0 <= min_speakers <= hi:
        raise ValueError(f"Invalid speaker-count window: [{min_speakers}, {max_speakers}].")
    if min_speakers == 0 and hi == np.inf:
        return [TimeSpan(0, cut.duration)]
    if not cut.supervisions:
        return [TimeSpan(0, cut.duration)] if min_speakers == 0 else []

    starts = np.fromiter((s.start for s in cut.supervisions), dtype=np.float64)
    ends = np.fromiter((s.end for s in cut.supervisions), dtype=np.float64)
    # Clamp to the cut span; anything fully outside contributes nothing.
    starts = np.clip(starts, 0.0, cut.duration)
    ends = np.clip(ends, 0.0, cut.duration)

    times = np.concatenate([[0.0], starts, ends, [cut.duration]])
    deltas = np.concatenate(
        [[0], np.ones_like(starts, dtype=np.int64), -np.ones_like(ends, dtype=np.int64), [0]]
    )
    order = np.argsort(times, kind="stable")
    times, deltas = times[order], deltas[order]
    # Collapse events at identical timestamps so zero-length intervals never
    # appear (start/end ties resolve within one timestamp).
    uniq_times, first_idx = np.unique(times, return_index=True)
    bucket_delta = np.add.reduceat(deltas, first_idx)
    active = np.cumsum(bucket_delta)  # speakers active on [t_i, t_{i+1})

    if len(uniq_times) < 2:
        return []
    keep = (active[:-1] >= min_speakers) & (active[:-1] <= hi)

    # Merge adjacent kept elementary intervals into maximal spans.
    spans: List[TimeSpan] = []
    run_start = None
    for i, flag in enumerate(keep):
        if flag and run_start is None:
            run_start = uniq_times[i]
        elif not flag and run_start is not None:
            spans.append(TimeSpan(run_start, uniq_times[i]))
            run_start = None
    if run_start is not None:
        spans.append(TimeSpan(run_start, uniq_times[-1]))
    return spans
