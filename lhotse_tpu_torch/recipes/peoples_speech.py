"""
The People's Speech recipe (copied from
``lhotse_tpu/recipes/peoples_speech.py``): 30,000+ hours of CC-licensed
English as 16 kHz FLAC trees, described per part by a JSON-lines manifest
whose ``training_data`` holds parallel lists of names, labels and audio
paths.
"""
import logging
from collections import defaultdict
from concurrent.futures.thread import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.serialization import load_jsonl
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

PEOPLES_SPEECH = (
    "train/dirty_sa", "train/dirty", "train/clean_sa", "train/clean", "validation/validation",
    "test/test")


def _parse_utterance(
    audio_dir: Path, text: str, audio_path: str, identifier: str,
) -> Tuple[Recording, SupervisionSegment]:
    full_path = audio_dir / audio_path
    recording = Recording.from_file(path=full_path, recording_id=full_path.stem)
    segment = SupervisionSegment(
        id=recording.id, recording_id=recording.id, start=0.0, duration=recording.duration,
        channel=0, text=text, language="English", custom={"session_id": identifier})
    return recording, segment


def _prepare_subset(
    subset: str, corpus_dir: Path, num_jobs: int = 1) -> Tuple[RecordingSet, SupervisionSet]:
    part_dir = corpus_dir / subset.split("/")[0]
    part_name = subset.split("/")[1]
    audio_dir = corpus_dir / subset
    recordings, supervisions = [], []
    with ThreadPoolExecutor(num_jobs) as ex:
        futures = []
        # Note: People's Speech manifest.json is really a JSONL.
        for item in load_jsonl(part_dir / f"{part_name}.json"):
            for _, text, audio_path in zip(*item["training_data"].values()):
                futures.append(
                    ex.submit(
                        _parse_utterance,
                        audio_dir,
                        text,
                        audio_path,
                        item["identifier"],
                    )
                )
        for future in futures:
            recording, segment = future.result()
            recordings.append(recording)
            supervisions.append(segment)
    recording_set, supervision_set = fix_manifests(
        RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))
    validate_recordings_and_supervisions(recording_set, supervision_set)
    return recording_set, supervision_set


def prepare_peoples_speech(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-part manifests keyed by e.g. "train/clean"."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    logging.info("Preparing People's Speech...")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    manifests = defaultdict(dict)
    for part in PEOPLES_SPEECH:
        part_name = part.split("/")[1]
        if not (corpus_dir / part).is_dir():
            logging.info(f"Skipping {part}: directory not found.")
            continue
        if manifests_exist(
            part=part_name, output_dir=output_dir, prefix="peoples_speech", suffix="jsonl.gz"):
            logging.info(f"People's Speech {part_name} already prepared - skipping.")
            # Return keys use the full "train/clean" form, so the generic
            # pre-populate (keyed by part_name) cannot be used here.
            cached = read_manifests_if_cached(
                dataset_parts=[part_name], output_dir=output_dir,
                prefix="peoples_speech", suffix="jsonl.gz")
            if cached and part_name in cached:
                manifests[part] = cached[part_name]
            continue
        recording_set, supervision_set = _prepare_subset(part, corpus_dir, num_jobs)
        if output_dir is not None:
            recording_set.to_file(output_dir / f"peoples_speech_recordings_{part_name}.jsonl.gz")
            supervision_set.to_file(
                output_dir / f"peoples_speech_supervisions_{part_name}.jsonl.gz"
            )
        manifests[part] = {"recordings": recording_set, "supervisions": supervision_set}
    return dict(manifests)
