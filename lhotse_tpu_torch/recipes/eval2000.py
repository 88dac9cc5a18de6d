"""
Eval2000 (Hub5'00) recipe (copied from ``lhotse_tpu/recipes/eval2000.py``):
the Switchboard evaluation set, two-channel 8 kHz SPHERE audio (LDC2002S09)
with its reference transcripts (LDC2002T43), one ``.txt`` file per
conversation of ``<start> <end> <side>: <words...>`` rows, ``#`` lines
skipped and the channel taken from the A/B side.
"""
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

EVAL2000_AUDIO_DIR = "LDC2002S09"
EVAL2000_TRANSCRIPT_DIR = "LDC2002T43"


def make_segments(transcript_dir_path: Path) -> List[SupervisionSegment]:
    segments = []
    for text_path in sorted(transcript_dir_path.rglob("*.txt")):
        trans_file = text_path.stem
        idx = -1
        for line in text_path.read_text().splitlines():
            fields = line.split()
            if not fields or fields[0].startswith("#"):
                continue
            idx += 1
            start, end = float(fields[0]), float(fields[1])
            side = fields[2].split(":")[0]
            segments.append(
                SupervisionSegment(
                    id=f"{trans_file}-{idx}",
                    recording_id=trans_file,
                    start=start,
                    duration=round(end - start, ndigits=8),
                    channel=0 if side == "A" else 1,
                    text=" ".join(fields[3:]),
                    language="English",
                    speaker=f"{trans_file}-{side}",
                )
            )
    return segments


def prepare_eval2000(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    transcript_path: Optional[Pathlike] = None, absolute_paths: bool = False, num_jobs: int = 1,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """One "all" split from the standard LDC layout."""
    corpus_dir = Path(corpus_dir)
    audio_dir = corpus_dir / EVAL2000_AUDIO_DIR / "hub5e_00" / "english"
    assert audio_dir.is_dir(), f"No such directory: {audio_dir}"
    transcript_dir = (
        Path(transcript_path)
        if transcript_path is not None
        else corpus_dir / EVAL2000_TRANSCRIPT_DIR / "reference" / "english"
    )
    assert transcript_dir.is_dir(), f"No such directory: {transcript_dir}"

    recordings = RecordingSet.from_recordings(
        Recording.from_file(
            path, relative_path_depth=None if absolute_paths else 3
        )
        for path in sorted(audio_dir.rglob("*.sph"))
    )
    supervisions = SupervisionSet.from_segments(make_segments(transcript_dir))
    recordings, supervisions = fix_manifests(recordings, supervisions)
    validate_recordings_and_supervisions(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        recordings.to_file(output_dir / "eval2000_recordings_all.jsonl.gz")
        supervisions.to_file(output_dir / "eval2000_supervisions_unnorm.jsonl.gz")
    return {"recordings": recordings, "supervisions": supervisions}
