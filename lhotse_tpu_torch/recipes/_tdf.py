"""
The parser of LDC TDF transcript tables (copied from
``lhotse_tpu/recipes/_tdf.py``), shared by GALE Arabic, GALE Mandarin and
Fisher Spanish. A TDF file is a tab-separated table with three header rows
and 13 payload columns per segment row. It is parsed with the ``csv``
module, not pandas: a row with fewer than 13 columns, or with a channel,
start or end that is not a number, is skipped with a warning.
"""
import csv
import logging
from pathlib import Path
from typing import Dict, Iterable, Iterator, List

from lhotse_tpu_torch.supervision import SupervisionSegment

TDF_COLUMNS = (
    "reco_id", "channel", "start", "end", "speaker", "gender", "dialect", "text",
    "section", "turn", "segment", "section_type", "su_type")


def iter_tdf_rows(path: Path) -> Iterator[Dict[str, str]]:
    """Yield cleaned column dicts for each well-formed row of one TDF file."""
    with open(path, encoding="utf-8", errors="replace", newline="") as f:
        for lineno, row in enumerate(csv.reader(f, delimiter="\t")):
            if lineno < 3 or not row:
                continue
            if len(row) < 13:
                logging.warning(f"Skipping malformed TDF row {path}:{lineno + 1}")
                continue
            rec = dict(zip(TDF_COLUMNS, row[:13]))
            try:
                rec["channel"] = int(rec["channel"])
                rec["start"] = float(rec["start"])
                rec["end"] = float(rec["end"])
            except ValueError:
                logging.warning(f"Skipping non-numeric TDF row {path}:{lineno + 1}")
                continue
            rec["reco_id"] = rec["reco_id"].strip().replace(".sph", "")
            rec["speaker"] = rec["speaker"].replace("*", "").strip()
            rec["text"] = rec["text"].strip()
            yield rec


def tdf_supervisions(
    transcript_paths: Iterable[Path], language: str,
    transform_text=None) -> List[SupervisionSegment]:
    """Supervisions for many TDF files; skips 'no speaker' rows, dedupes ids,
    drops non-positive durations, and carries the section metadata in custom."""
    supervisions = []
    seen = set()
    for path in transcript_paths:
        for idx, row in enumerate(iter_tdf_rows(Path(path))):
            if row["speaker"] == "no speaker":
                continue
            sup_id = f"{row['reco_id']}-{row['speaker']}-{idx}"
            duration = round(row["end"] - row["start"], ndigits=8)
            if sup_id in seen or duration <= 0:
                continue
            seen.add(sup_id)
            text = row["text"]
            if transform_text is not None:
                text = transform_text(text)
            supervisions.append(
                SupervisionSegment(
                    id=sup_id, recording_id=row["reco_id"], start=row["start"],
                    duration=duration, speaker=row["speaker"], gender=row["gender"],
                    language=language, text=text, channel=row["channel"],
                    custom={
                        "dialect": row["dialect"], "section": row["section"],
                        "turn": row["turn"], "segment": row["segment"],
                        "section_type": row["section_type"], "su_type": row["su_type"]}))
    return supervisions
