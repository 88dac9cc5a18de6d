"""
Fisher English Parts 1 and 2 recipe (copied from
``lhotse_tpu/recipes/fisher_english.py``): about 2,000 h of two-channel
8 kHz telephone conversations in SPHERE (LDC2004S13, LDC2005S13) with one
transcript per call (LDC2004T19, LDC2005T19). A transcript holds
``<start> <end> <A|B>: <words>`` rows after a 3-line header; the
``*_calldata.tbl`` tables map each call to the PINs of its A and B
speakers. Recordings are probed in a process pool and transcripts parsed in
a thread pool, both taken in submission order, so the manifests are the
same at any ``num_jobs``. The intermediate manifests are cached in
``output_dir`` so that an interrupted run resumes. The corpus is
LDC-licensed: there is no download.
"""
import logging
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

FISHER_AUDIO_DIRS = ["LDC2004S13", "LDC2005S13"]
FISHER_TRANSCRIPT_DIRS = ["LDC2004T19", "LDC2005T19"]

_CHANNELS = {"A": 0, "B": 1}


def _rglob_one(root: Path, pattern: str) -> Path:
    hits = sorted(root.rglob(pattern))
    if not hits:
        raise ValueError(f"No files matching {pattern} under {root}")
    return hits[0]


def create_recording(audio_path_and_rel_path_depth) -> Optional[Recording]:
    audio_path, depth = audio_path_and_rel_path_depth
    try:
        return Recording.from_file(audio_path, relative_path_depth=depth)
    except Exception:
        return None


def _fix_known_typos(session_id: str, rows: list) -> list:
    if session_id == "11487":
        # One row has start 31.09 but clearly means 231.09.
        rows = [[231.09, *r[1:]] if r[0] == 31.09 and r[1] == 234.06 else r for r in rows]
    return rows


def create_supervision(sessions_and_transcript_path) -> List[SupervisionSegment]:
    sessions, transcript_path = sessions_and_transcript_path
    transcript_path = Path(transcript_path)
    if not transcript_path.is_file():
        return []
    session_id = transcript_path.stem.split("_")[2]
    rows = []
    for line in transcript_path.read_text(encoding="utf8").splitlines()[3:]:
        fields = line.split()
        if not fields:
            continue
        rows.append(
            [
                float(fields[0]),
                float(fields[1]),
                fields[2][:-1],  # strip ':' from "A:"/"B:"
                " ".join(w for w in fields[3:] if w.strip()),
            ]
        )
    rows = _fix_known_typos(session_id, rows)
    width = len(str(len(rows)))
    return [
        SupervisionSegment(
            id=f"{transcript_path.stem}-{str(k).zfill(width)}",
            recording_id=transcript_path.stem,
            start=round(start, 3),
            duration=round(end - start, 3),
            channel=_CHANNELS[side],
            text=words,
            language="English",
            speaker=sessions[session_id][side],
        )
        for k, (start, end, side, words) in enumerate(rows)]


def prepare_fisher_english(
    corpus_dir: Pathlike, output_dir: Pathlike, audio_dirs: List[str] = FISHER_AUDIO_DIRS,
    transcript_dirs: List[str] = FISHER_TRANSCRIPT_DIRS, absolute_paths: bool = False,
    num_jobs: int = 1) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """
    Fisher English manifests (one big 'recordings' + 'supervisions' pair).
    Intermediate manifests are cached in ``output_dir`` so interrupted runs
    resume cheaply.
    """
    corpus_dir, output_dir = Path(corpus_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for sub in audio_dirs + transcript_dirs:
        if not (corpus_dir / sub).is_dir():
            raise ValueError(f"Could not find '{sub}' directory inside '{corpus_dir}'.")

    audio_paths = sorted(
        p
        for audio_dir in audio_dirs
        for p in (corpus_dir / audio_dir).rglob("*.sph")
    )
    transcript_paths = sorted(
        p
        for t_dir in transcript_dirs
        for p in (corpus_dir / t_dir).rglob("*.txt")
        if "doc" not in p.parts
    )

    # Session -> {A: speaker-pin, B: speaker-pin}
    sessions: Dict[str, Dict[str, str]] = {}
    for t_dir in transcript_dirs:
        table = _rglob_one(corpus_dir / t_dir / "doc", "*_calldata.tbl")
        for line in table.read_text(encoding="utf8").splitlines()[1:]:
            fields = line.rstrip("\n").split(",")
            sessions[fields[0]] = {"A": fields[5], "B": fields[10]}
    if len(transcript_paths) != len(audio_paths):
        raise AssertionError(
            f"Found {len(audio_paths)} sphere files but {len(transcript_paths)} "
            f"transcripts."
        )
    if len(transcript_paths) != len(sessions):
        warnings.warn(
            f"Fisher's *_calldata.tbl files indicate there should be "
            f"{len(sessions)} sessions, but scanning found {len(transcript_paths)}."
        )

    recs_path = output_dir / "recordings_notfixed.jsonl.gz"
    if recs_path.is_file():
        logging.info(f"Using existing recording manifest at {recs_path}")
        recordings = RecordingSet.from_jsonl_lazy(recs_path)
    else:
        logging.info("Building fresh recording manifest")
        inputs = [(p, None if absolute_paths else 5) for p in audio_paths]
        failed = 0
        with ProcessPoolExecutor(num_jobs) as pool, RecordingSet.open_writer(recs_path) as writer:
            for rec in pool.map(create_recording, inputs):
                if rec is None:
                    failed += 1
                else:
                    writer.write(rec, flush=True)
        if failed:
            warnings.warn(
                f"Out of {len(inputs)} recordings, {failed} had errors and "
                f"were omitted."
            )
        recordings = writer.open_manifest()

    sups_path = output_dir / "supervisions_notfixed.jsonl.gz"
    if sups_path.is_file():
        logging.info(f"Using existing supervision manifest at {sups_path}")
        supervisions = SupervisionSet.from_jsonl_lazy(sups_path)
    else:
        logging.info("Building fresh supervision manifest")
        inputs = [(sessions, p) for p in transcript_paths]
        empty = 0
        with ThreadPoolExecutor(max(num_jobs, 4)) as pool, SupervisionSet.open_writer(
            sups_path
        ) as writer:
            for segs in pool.map(create_supervision, inputs):
                if not segs:
                    empty += 1
                for s in segs:
                    writer.write(s)
        supervisions = writer.open_manifest()
        if empty:
            warnings.warn(
                f"Out of {len(inputs)} transcript files, {empty} had errors "
                f"and were omitted."
            )

    recordings, supervisions = fix_manifests(recordings.to_eager(), supervisions.to_eager())
    validate_recordings_and_supervisions(recordings, supervisions)
    recordings.to_file(output_dir / "fisher-english_recordings_all.jsonl.gz")
    supervisions.to_file(output_dir / "fisher-english_supervisions_all.jsonl.gz")
    return {"recordings": recordings, "supervisions": supervisions}
