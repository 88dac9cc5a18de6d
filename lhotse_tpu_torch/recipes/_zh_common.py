"""
The shared skeleton of the simple Chinese corpora (copied from
``lhotse_tpu/recipes/_zh_common.py``; its ``download_tars`` is not ported:
it needs the network): per-split manifests built by pairing the scanned
WAV files with a transcript table.
"""
import logging
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def build_part_manifests(
    wav_paths: Iterable[Path], transcript_dict: Dict[str, str],
    speaker_of: Callable[[Path], Optional[str]], language: str = "Chinese",
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """One split's manifests: a recording and a whole-file supervision for
    every WAV file (in sorted order) whose stem has a transcript."""
    recordings, supervisions = [], []
    for audio_path in sorted(wav_paths):
        idx = audio_path.stem
        if idx not in transcript_dict:
            logging.warning(f"{audio_path} has no transcript.")
            continue
        recording = Recording.from_file(audio_path)
        recordings.append(recording)
        supervisions.append(
            SupervisionSegment(
                id=idx,
                recording_id=idx,
                start=0.0,
                duration=recording.duration,
                channel=0,
                language=language,
                speaker=speaker_of(audio_path),
                text=transcript_dict[idx].strip(),
            )
        )
    recording_set = RecordingSet.from_recordings(recordings)
    supervision_set = SupervisionSet.from_segments(supervisions)
    if recordings:  # an absent split legitimately yields empty manifests
        recording_set, supervision_set = fix_manifests(recording_set, supervision_set)
        validate_recordings_and_supervisions(recording_set, supervision_set)
    return {"recordings": recording_set, "supervisions": supervision_set}


def maybe_store(manifests, output_dir: Optional[Pathlike], prefix: str, part: str):
    """Write ``{prefix}_{recordings,supervisions}_{part}.jsonl.gz`` when an
    output directory is given."""
    if output_dir is None:
        return
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    manifests["recordings"].to_file(output_dir / f"{prefix}_recordings_{part}.jsonl.gz")
    manifests["supervisions"].to_file(output_dir / f"{prefix}_supervisions_{part}.jsonl.gz")
