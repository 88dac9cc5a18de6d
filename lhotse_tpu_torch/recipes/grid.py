"""
GRID recipe (copied from ``lhotse_tpu/recipes/grid.py``): the audio-visual
sentence corpus, 34 talkers x 1000 short command sentences ("put red at G9
now") with word alignments (https://zenodo.org/record/3625687). One
Recording per ``.mpg`` video under the corpus (read by the audio backends,
which know a file by its content), supervisions from the ``.align`` files
in ``alignments/<speaker>/`` (times in 1/1000 s, ``sil`` dropped from the
text). The videos are read by ``parallel_map`` (spawned processes where
``num_jobs`` > 1) and taken in the order they were found (the JAX package
forks a pool and takes them as they complete, so its manifests' order can
change from run to run). The download, which goes through
``zenodo_get``, is not ported.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def process_single(
    video_path: Path, speaker: str, ali_dir: Path, with_supervisions: bool):
    """One (Recording, Optional[SupervisionSegment]) for one .mpg video."""
    video_id = video_path.stem
    try:
        recording = Recording.from_file(video_path, recording_id=f"{speaker}_{video_id}")
    except Exception as e:
        logging.warning(f"Unexpected error for {video_path}: {e}")
        return None
    supervision = None
    ali_path = (ali_dir / speaker / video_id).with_suffix(".align")
    if with_supervisions and ali_path.is_file():
        ali = [
            AlignmentItem(symbol=w, start=float(b) / 1000,
                          duration=float(int(e) - int(b)) / 1000)
            for b, e, w in (line.split() for line in ali_path.read_text().splitlines())]
        supervision = SupervisionSegment(
            id=recording.id, recording_id=recording.id, start=0.0,
            duration=recording.duration, channel=recording.channel_ids,
            text=" ".join(item.symbol for item in ali if item.symbol != "sil"),
            language="English", speaker=speaker, alignment={"word": ali})
    return recording, supervision


def _process_or_skip(
    video_path: Path, speaker: str, ali_dir: Path, with_supervisions: bool):
    """``process_single``, or None where it raises (the video is skipped, as
    in the JAX package)."""
    try:
        return process_single(video_path, speaker, ali_dir, with_supervisions)
    except Exception as e:
        logging.warning(f"Skipped {video_path}: {e!r}")
        return None


def prepare_grid(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    with_supervisions: bool = True, num_jobs: int = 1,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Recordings (and alignment supervisions) off the extracted Grid tree."""
    corpus_dir = Path(corpus_dir)
    ali_dir = corpus_dir / "alignments"
    assert ali_dir.is_dir()
    assert (corpus_dir / "audio_25k").is_dir()

    videos = [p for p in corpus_dir.rglob("*.mpg") if "MACOSX" not in str(p)]
    recordings, supervisions = [], []
    for result in parallel_map(
            _process_or_skip, videos, [p.parent.name for p in videos], [ali_dir] * len(videos),
            [with_supervisions] * len(videos), num_jobs=num_jobs):
        if result is None:
            continue
        recording, maybe_supervision = result
        recordings.append(recording)
        if maybe_supervision is not None:
            supervisions.append(maybe_supervision)

    recordings = RecordingSet.from_recordings(recordings)
    if with_supervisions:
        fixed = finalize_manifests(recordings, supervisions)
        recordings, supervisions = fixed["recordings"], fixed["supervisions"]
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        recordings.to_file(output_dir / "grid_recordings.jsonl.gz")
        if with_supervisions:
            supervisions.to_file(output_dir / "grid_supervisions.jsonl.gz")
    out = {"recordings": recordings}
    if with_supervisions:
        out["supervisions"] = supervisions
    return out
