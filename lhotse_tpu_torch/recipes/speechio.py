"""
SpeechIO recipe (copied from ``lhotse_tpu/recipes/speechio.py``): the Chinese
ASR leaderboard test sets SPEECHIO_ASR_ZH00000..26, obtained manually from
https://github.com/SpeechColab/Leaderboard. One directory per test set,
each with a ``metadata.tsv`` of ID/AUDIO/TEXT columns (parsed with the csv
module); the speaker is the id's prefix before "_". A listed file that is
missing is skipped with a warning.
"""
import csv
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

SPEECHIO_TESTSET_INDEX = 26  # test sets 00..26 are currently open-source

SPEECHIO_PARTS = tuple(
    f"SPEECHIO_ASR_ZH000{i:02d}" for i in range(SPEECHIO_TESTSET_INDEX + 1))


def _parse_one_subset(part_dir: Path):
    recordings, segments = [], []
    with open(part_dir / "metadata.tsv", encoding="utf-8", newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            audio_path = part_dir / row["AUDIO"]
            if not audio_path.exists():
                logging.warning(f"Audio file {audio_path} does not exist - skipping.")
                continue
            recording = Recording.from_file(audio_path)
            recordings.append(recording)
            recording_id = row["ID"]
            segments.append(
                SupervisionSegment(
                    id=f"{part_dir}-{recording_id}", recording_id=recording_id, start=0,
                    duration=recording.duration, channel=0, language="Chinese",
                    speaker=recording_id.split("_")[0], text=row["TEXT"]))
    return recordings, segments


def prepare_speechio(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """One manifest pair per present SPEECHIO_ASR_ZH000NN test-set directory."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    logging.info("Preparing SpeechIO...")

    manifests = read_manifests_if_cached(
        dataset_parts=SPEECHIO_PARTS, output_dir=output_dir, prefix="speechio") or {}
    for part in SPEECHIO_PARTS:
        if manifests_exist(part=part, output_dir=output_dir, prefix="speechio"):
            logging.info(f"SpeechIO subset: {part} already prepared - skipping.")
            continue
        part_dir = corpus_dir / part
        if not part_dir.is_dir():
            continue
        recordings, segments = _parse_one_subset(part_dir)
        manifests[part] = finalize_manifests(
            recordings, segments, output_dir=output_dir, prefix="speechio", part=part)
    return manifests
