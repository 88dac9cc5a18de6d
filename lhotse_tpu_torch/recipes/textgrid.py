"""
A minimal Praat TextGrid reader (long "ooTextFile" format; copied from
``lhotse_tpu/recipes/textgrid.py``), enough for the meeting-corpus recipes
(AliMeeting, AISHELL-4) without the optional ``textgrid`` package. Only
IntervalTiers are surfaced; point tiers are skipped.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

_NUM = re.compile(r"=\s*([-\d.eE+]+)")
_TEXT = re.compile(r'=\s*"(.*)"\s*$')


@dataclass
class Interval:
    minTime: float
    maxTime: float
    mark: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval] = field(default_factory=list)


def parse_textgrid(text: str) -> List[Tier]:
    """Parse the long TextGrid format into a list of interval tiers."""
    lines = [ln.strip() for ln in text.splitlines()]
    tiers: List[Tier] = []
    current: Tier = None
    pending = {}

    def flush_interval():
        nonlocal pending
        if current is not None and {"xmin", "xmax", "text"} <= set(pending):
            current.intervals.append(Interval(pending["xmin"], pending["xmax"], pending["text"]))
        pending = {}

    in_interval_tier = False
    for ln in lines:
        if ln.startswith("class"):
            m = _TEXT.search(ln)
            in_interval_tier = bool(m) and m.group(1) == "IntervalTier"
            current = None
        elif ln.startswith("name"):
            m = _TEXT.search(ln)
            if in_interval_tier and m:
                flush_interval()
                current = Tier(name=m.group(1))
                tiers.append(current)
        elif ln.startswith("intervals [") or ln.startswith("intervals:"):
            flush_interval()
        elif ln.startswith("xmin") and current is not None:
            m = _NUM.search(ln)
            if m:
                pending["xmin"] = float(m.group(1))
        elif ln.startswith("xmax") and current is not None:
            m = _NUM.search(ln)
            if m:
                pending["xmax"] = float(m.group(1))
        elif ln.startswith("text") and current is not None:
            m = _TEXT.search(ln)
            if m:
                pending["text"] = m.group(1)
                flush_interval()
    flush_interval()
    if not tiers:
        raise ValueError("No IntervalTier found — not a (long-format) TextGrid?")
    return tiers


def read_textgrid(path) -> List[Tier]:
    """Read a TextGrid file, trying UTF-8 then UTF-16 (Praat's default)."""
    raw = Path(path).read_bytes()
    for enc in ("utf-8", "utf-16"):
        try:
            return parse_textgrid(raw.decode(enc))
        except UnicodeDecodeError:
            continue
    raise ValueError(f"Cannot decode TextGrid file: {path}")
