"""
Earnings-21 (copied from ``lhotse_tpu/recipes/earnings21.py``): 44
long-form earnings calls (~39 h) with NLP-format transcripts, from the
rev.com speech-datasets repository::

    earnings21/
      media/*.mp3
      transcripts/nlp_references/*.nlp   # token|...| rows, header first

One supervision per call. ``download_earnings21`` is not ported: it needs
the network.
"""
import string
from pathlib import Path
from typing import Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def normalize(text: str) -> str:
    """Strip punctuation and lowercase."""
    return text.translate(str.maketrans("", "", string.punctuation)).lower()


def parse_nlp_file(filename: Pathlike):
    """First (token) column of an .nlp file, header skipped."""
    rows = Path(filename).read_text().splitlines()
    return [row.split("|")[0] for row in rows[1:] if row]


def prepare_earnings21(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, normalize_text: bool = False,
) -> Union[RecordingSet, SupervisionSet]:
    """
    Earnings-21 manifests: one whole-call supervision per mp3.

    .. caution:: ``normalize_text=True`` removes all punctuation and
        lowercases the transcript.
    """
    corpus_dir = Path(corpus_dir)
    recordings = RecordingSet.from_recordings(
        Recording.from_file(p) for p in sorted((corpus_dir / "media").glob("*.mp3"))
    )
    nlp_files = sorted((corpus_dir / "transcripts" / "nlp_references").glob("*.nlp"))
    supervisions = []
    for nlp in nlp_files:
        text = " ".join(parse_nlp_file(nlp))
        supervisions.append(
            SupervisionSegment(
                id=nlp.stem,
                recording_id=nlp.stem,
                start=0.0,
                duration=recordings[nlp.stem].duration,
                channel=0,
                language="English",
                text=normalize(text) if normalize_text else text,
            )
        )
    supervisions = SupervisionSet.from_segments(supervisions)
    recordings, supervisions = fix_manifests(recordings, supervisions)
    validate_recordings_and_supervisions(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        supervisions.to_file(output_dir / "earnings21_supervisions_all.jsonl.gz")
        recordings.to_file(output_dir / "earnings21_recordings_all.jsonl.gz")
    return recordings, supervisions
