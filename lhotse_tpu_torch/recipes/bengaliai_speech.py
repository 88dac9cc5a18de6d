"""
Bengali.AI Speech recipe (copied from ``lhotse_tpu/recipes/bengaliai_speech.py``):
about 1,200 h of Bengali MP3 recordings from the Kaggle competition
(https://arxiv.org/abs/2305.09688), downloaded by hand with ``kaggle
competitions download -c bengaliai-speech``. The rows of ``train.csv``
tagged ``,train`` or ``,valid`` split the ``train_mp3s`` pool; the hidden
test set is the text-less ``test_mp3s`` directory. The MP3s are read
through ``audio/syscodecs.py``.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

BENGALIAI_SPEECH = ("train", "valid", "test")


def _read_split_tables(train_csv: Path) -> Tuple[Dict[str, str], Dict[str, str]]:
    train_info, valid_info = {}, {}
    for line in train_csv.read_text().splitlines()[1:]:
        if ",train" in line:
            audio_id, text = line.replace(",train", "").split(",", 1)
            train_info[audio_id] = text
        elif ",valid" in line:
            audio_id, text = line.replace(",valid", "").split(",", 1)
            valid_info[audio_id] = text
    return train_info, valid_info


def _prepare_subset(subset: str, corpus_dir: Path, audio_info: Optional[dict]):
    part_path = corpus_dir / ("test_mp3s" if subset == "test" else "train_mp3s")
    recordings, supervisions = [], []
    for audio_path in sorted(part_path.rglob("*.mp3")):
        audio_id = audio_path.stem
        if audio_info is not None and audio_id not in audio_info:
            continue
        if not audio_path.is_file():
            logging.warning(f"No such file: {audio_path}")
            continue
        recording = Recording.from_file(path=audio_path, recording_id=audio_id)
        recordings.append(recording)
        supervisions.append(
            SupervisionSegment(
                id=audio_id, recording_id=audio_id,
                text=audio_info[audio_id] if audio_info is not None else None,
                start=0.0, duration=recording.duration, channel=0, language="Bengali"))
    return recordings, supervisions


def prepare_bengaliai_speech(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """train/valid/test manifests off the Kaggle competition layout."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    logging.info("Preparing Bengali.AI Speech...")
    train_info, valid_info = _read_split_tables(corpus_dir / "train.csv")
    split_tables = {"train": train_info, "valid": valid_info, "test": None}

    manifests = read_manifests_if_cached(
        dataset_parts=BENGALIAI_SPEECH, output_dir=output_dir,
        prefix="bengaliai_speech", suffix="jsonl.gz") or {}
    for part in BENGALIAI_SPEECH:
        if manifests_exist(
                part=part, output_dir=output_dir, prefix="bengaliai_speech",
                suffix="jsonl.gz"):
            logging.info(f"Bengali.AI Speech subset: {part} already prepared - skipping.")
            continue
        logging.info(f"Processing Bengali.AI Speech subset: {part}")
        recordings, supervisions = _prepare_subset(part, corpus_dir, split_tables[part])
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir,
            prefix="bengaliai_speech", part=part)
    return manifests
