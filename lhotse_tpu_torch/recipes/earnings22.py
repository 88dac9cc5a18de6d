"""
Earnings-22 (copied from ``lhotse_tpu/recipes/earnings22.py``): 125
earnings calls (~119 h) of accented English from rev.com's speech-datasets
repository; MP3 media, ``.nlp`` token tables and ``metadata.csv`` (the
accent or language region in its fifth kept column). One supervision per
call. ``download_earnings22`` is not ported (in the JAX package it only
points at the repository).
"""
import string
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def normalize(text: str) -> str:
    return text.translate(str.maketrans("", "", string.punctuation)).lower()


def read_metadata(path: Pathlike) -> Dict[str, List[str]]:
    with open(path) as f:
        f.readline()  # header
        out = {}
        for line in f:
            fields = line.split(",")
            out[fields[0]] = fields[1:-1]
        return out


def parse_nlp_file(filename: Pathlike) -> List[str]:
    """.nlp files: pipe-separated rows, token text in the first column."""
    with open(filename) as f:
        f.readline()  # header
        return [line.split("|")[0] for line in f]


def prepare_earnings22(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, normalize_text: bool = False,
) -> Tuple[RecordingSet, SupervisionSet]:
    """One "all" split: (recordings, supervisions) for the 125 calls."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    audio_files = sorted((corpus_dir / "media").glob("*.mp3"))
    recording_set = RecordingSet.from_recordings(Recording.from_file(p) for p in audio_files)
    metadata = read_metadata(corpus_dir / "metadata.csv")

    supervision_segments = []
    for nlp_file in sorted((corpus_dir / "transcripts" / "nlp_references").glob("*.nlp")):
        rec_id = nlp_file.stem
        text = " ".join(parse_nlp_file(nlp_file))
        if normalize_text:
            text = normalize(text)
        supervision_segments.append(
            SupervisionSegment(
                id=rec_id,
                recording_id=rec_id,
                start=0.0,
                duration=recording_set[rec_id].duration,
                channel=0,
                language=f"English-{metadata[rec_id][4]}",
                text=text,
            )
        )
    supervision_set = SupervisionSet.from_segments(supervision_segments)
    recording_set, supervision_set = fix_manifests(recording_set, supervision_set)
    validate_recordings_and_supervisions(recording_set, supervision_set)
    if output_dir is not None:
        recording_set.to_file(output_dir / "earnings22_recordings_all.jsonl.gz")
        supervision_set.to_file(output_dir / "earnings22_supervisions_all.jsonl.gz")
    return recording_set, supervision_set
