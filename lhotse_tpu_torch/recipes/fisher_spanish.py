"""
Fisher Spanish recipe (copied from ``lhotse_tpu/recipes/fisher_spanish.py``):
two-channel 8 kHz telephone conversations in SPHERE (LDC2010S01) with TDF
transcripts (LDC2010T04). The sessions table ``*_call.tbl`` maps each
session to the speaker of each channel; supervision ids are zero-padded
per file.
"""
import csv
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._tdf import iter_tdf_rows
from lhotse_tpu_torch.recipes.fisher_english import create_recording
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob


def create_supervision(sessions: Dict[str, Dict[int, str]],
                       transcript_path: Path) -> List[SupervisionSegment]:
    transcript_path = Path(transcript_path)
    session_id = transcript_path.stem.split("_")[2]
    rows = list(iter_tdf_rows(transcript_path))
    width = len(str(len(rows)))
    segments = []
    for k, row in enumerate(rows):
        text = " ".join(w for w in row["text"].split() if w.strip())
        segments.append(
            SupervisionSegment(
                id=f"{transcript_path.stem}-{str(k).zfill(width)}",
                recording_id=transcript_path.stem, start=round(row["start"], 10),
                duration=round(row["end"] - row["start"], 10), channel=row["channel"],
                text=text, language="Spanish",
                speaker=sessions[session_id][row["channel"]]))
    return segments


def prepare_fisher_spanish(
    audio_dir_path: Pathlike, transcript_dir_path: Pathlike,
    output_dir: Optional[Pathlike] = None, absolute_paths: bool = False,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Single-part manifests off the LDC2010S01 + LDC2010T04 trees."""
    audio_paths = check_and_rglob(audio_dir_path, "*.sph")
    transcript_paths = check_and_rglob(transcript_dir_path, "*.tdf")

    sessions_table = check_and_rglob(transcript_dir_path, "*_call.tbl")[0]
    with open(sessions_table, encoding="utf8", newline="") as f:
        rows = list(csv.reader(f))[1:]
    sessions = {r[0]: {0: r[2], 1: r[8]} for r in rows}

    if not (len(transcript_paths) == len(sessions) == len(audio_paths)):
        raise AssertionError(
            f"Mismatched Fisher Spanish inventory: {len(audio_paths)} sph, "
            f"{len(transcript_paths)} tdf, {len(sessions)} sessions")

    logging.info("Collecting Fisher Spanish recordings")
    depth = None if absolute_paths else 4
    with ThreadPoolExecutor() as pool:
        recordings = list(
            pool.map(create_recording, ((p, depth) for p in audio_paths)))
        supervision_lists = list(
            pool.map(lambda p: create_supervision(sessions, p), transcript_paths))
    recordings = RecordingSet.from_recordings(r for r in recordings if r is not None)
    supervisions = SupervisionSet.from_segments(
        s for sl in supervision_lists for s in sl).filter(lambda s: s.duration > 0.0)

    manifests = finalize_manifests(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        manifests["recordings"].to_file(output_dir / "fisher-spanish_recordings_all.jsonl")
        manifests["supervisions"].to_file(output_dir / "fisher-spanish_supervisions_all.jsonl")
    return manifests
