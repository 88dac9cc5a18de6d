"""
Hi-Fi TTS recipe (copied from ``lhotse_tpu/recipes/hifitts.py``): 10
LibriVox narrators, 44.1 kHz studio-quality audiobook speech (OpenSLR 109)
with one jsonl manifest per partition::

    hi_fi_tts_v0/
      <spk>_manifest_<clean|other>_<train|dev|test>.json   # jsonl rows
      audio/... (referenced by each row's audio_filepath)

The partitions are prepared by ``parallel_map`` (spawned processes where
``num_jobs`` > 1, taken in the order of their manifests' names; the JAX
package forks a pool and takes them as they complete); a partition whose
manifests are already in ``output_dir`` is read back, not prepared again.
The download is not ported.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.serialization import load_jsonl
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

ID2SPEAKER = {
    "92": "Cori Samuel", "6097": "Phil Benson", "9017": "John Van Stan", "6670": "Mike Pelton",
    "6671": "Tony Oliva", "8051": "Maria Kasper", "9136": "Helen Taylor", "11614": "Sylviamb",
    "11697": "Celine Major", "12787": "LikeManyWaters"}
ID2GENDER = {
    "92": "F", "6097": "M", "9017": "M", "6670": "M", "6671": "M", "8051": "F", "9136": "F",
    "11614": "F", "11697": "F", "12787": "F"}


def to_partition_id(path: Path) -> str:
    spk, _, quality, split = path.stem.split("_")
    return f"{spk}_{quality}_{split}"


def prepare_single_partition(
    raw_manifest_path: Path, corpus_dir: Path, speaker_id: str, clean_or_other: str):
    recordings, supervisions = [], []
    for meta in load_jsonl(raw_manifest_path):
        rec = Recording.from_file(corpus_dir / meta["audio_filepath"])
        recordings.append(rec)
        supervisions.append(
            SupervisionSegment(
                id=rec.id,
                recording_id=rec.id,
                start=0,
                duration=rec.duration,
                channel=0,
                text=meta["text"],
                speaker=ID2SPEAKER[speaker_id],
                gender=ID2GENDER[speaker_id],
                custom={"text_punct": meta["text_normalized"], "split": clean_or_other},
            )
        )
    out = finalize_manifests(recordings, supervisions)
    return out["recordings"], out["supervisions"]


def prepare_hifitts(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Hi-Fi TTS manifests, one partition per (speaker, quality, split), e.g.
    ``manifests['92_clean_train']``.
    """
    corpus_dir = Path(corpus_dir)
    json_manifests = sorted(corpus_dir.glob("*_manifest_*.json"))
    if not json_manifests:
        raise AssertionError(f"No HiFiTTS jsonl manifests under {corpus_dir}")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    partition_ids = [to_partition_id(raw) for raw in json_manifests]
    manifests = read_manifests_if_cached(
        dataset_parts=partition_ids, output_dir=output_dir, prefix="hifitts") or {}
    todo = []
    for raw, pid in zip(json_manifests, partition_ids):
        if manifests_exist(part=pid, output_dir=output_dir, prefix="hifitts"):
            logging.info(f"HiFiTTS partition {pid} already prepared - skipping.")
            continue
        todo.append(raw)
    fields = [raw.stem.split("_") for raw in todo]  # <spk>_manifest_<quality>_<split>
    done = parallel_map(
        prepare_single_partition, todo, [corpus_dir] * len(todo), [f[0] for f in fields],
        [f[2] for f in fields], num_jobs=num_jobs)
    for raw, (recordings, supervisions) in zip(todo, done):
        pid = to_partition_id(raw)
        if output_dir is not None:
            supervisions.to_file(output_dir / f"hifitts_supervisions_{pid}.jsonl.gz")
            recordings.to_file(output_dir / f"hifitts_recordings_{pid}.jsonl.gz")
        manifests[pid] = {"recordings": recordings, "supervisions": supervisions}
    return manifests
