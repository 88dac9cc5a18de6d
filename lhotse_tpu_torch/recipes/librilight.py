"""
Libri-Light recipe (copied from ``lhotse_tpu/recipes/librilight.py``):
60k hours of unlabelled English audiobook speech in three subsets (small,
medium, large), 16 kHz FLAC. Each FLAC file has a sibling JSON with the
speaker id and the voice-activity intervals, which become (textless)
supervisions.

Layout::

    <subset>/<speaker>/<book>/<file>.flac + <file>.json

``LIBRILIGHT_URL`` is not ported: the subsets are downloaded by hand.
"""
import json
import logging
from concurrent.futures.thread import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, add_durations

LIBRILIGHT = ("small", "medium", "large")


def _parse_utterance(corpus_dir: Path, flac: Path):
    rec_id = str(flac.with_suffix("")).replace(str(corpus_dir) + "/", "")
    flac = flac.resolve()
    if not flac.is_file():
        logging.warning(f"No such file: {flac}")
        return None
    meta = json.loads(flac.with_suffix(".json").read_text())
    recording = Recording.from_file(path=flac, recording_id=rec_id)
    sups = [
        SupervisionSegment(
            id=f"{rec_id}_{k}", recording_id=rec_id, start=lo,
            duration=add_durations(hi, -lo, sampling_rate=16000), channel=0, language="English",
            speaker=meta["speaker"])
        for k, (lo, hi) in enumerate(meta["voice_activity"])]
    return recording, sups


def prepare_librilight(
    corpus_dir: Pathlike, dataset_parts: Union[str, Sequence[str]] = "auto",
    output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-subset Libri-Light manifests (VAD intervals as supervisions)."""
    corpus_dir = Path(corpus_dir)
    if dataset_parts == "auto":
        dataset_parts = [p for p in LIBRILIGHT if (corpus_dir / p).is_dir()]
    elif isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]

    manifests = {}
    if output_dir is not None:
        manifests = read_manifests_if_cached(
            dataset_parts=dataset_parts, output_dir=output_dir, prefix="librilight") or {}

    for part in dataset_parts:
        if manifests_exist(part=part, output_dir=output_dir, prefix="librilight"):
            logging.info(f"Libri-Light subset {part} already prepared - skipping.")
            continue
        flacs = sorted((corpus_dir / part).rglob("*.flac"))
        recordings, supervisions = [], []
        with ThreadPoolExecutor(num_jobs) as pool:
            for result in pool.map(lambda p: _parse_utterance(corpus_dir, p), flacs):
                if result is None:
                    continue
                recordings.append(result[0])
                supervisions.extend(result[1])
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir, prefix="librilight", part=part)
    return manifests
