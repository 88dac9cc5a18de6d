"""
otoSpeech recipe (copied from ``lhotse_tpu/recipes/oto_speech.py``):
full-duplex spontaneous multi-speaker conversations (141 h) for
speech-to-speech and dialogue modelling, with Parakeet-v3 pseudo labels
(https://huggingface.co/datasets/otoearth/otoSpeech-full-duplex-processed-141h).
Each part's tar shards (``data/<part>/*.tar``) are extracted once and
flattened into ``data/<part>/unpacked/`` (a ``<shard>.done`` marker beside
them); the FLAC sessions are resampled lazily to ``target_sr``; the
segments of ``seglst.json`` become supervisions with word alignments
relative to the segment. The download, which needs ``huggingface_hub``,
``gdown`` and an access token, is not ported.
"""
import json
import logging
import tarfile
from pathlib import Path
from typing import Dict, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, safe_extract


def extract_and_flatten_tar(tar_path: Path, extract_dir: Path) -> None:
    """Extract one tar shard, flatten its tree, and drop a .done marker."""
    marker = extract_dir / f"{tar_path.name}.done"
    if marker.exists():
        return
    with tarfile.open(tar_path) as tar:
        safe_extract(tar, path=extract_dir)
    for p in extract_dir.rglob("*"):
        if p.is_file() and p.parent != extract_dir and p.suffix != ".done":
            target_path = extract_dir / p.name
            if not target_path.exists():
                p.rename(target_path)
    marker.touch()


def _segment_from_label(seg: dict, idx: int) -> SupervisionSegment:
    start, end = seg["start_time"], seg["end_time"]
    alignment = None
    if "word_alignment" in seg:
        alignment = {
            "word": [
                AlignmentItem(
                    symbol=w_text, start=round(w_start - start, 4),
                    duration=round(w_end - w_start, 4))
                for w_text, w_start, w_end in seg["word_alignment"]]}
    return SupervisionSegment(
        id=f"{seg['session_id']}-{idx}", recording_id=seg["session_id"], start=start,
        duration=round(end - start, 4), channel=0, text=seg["words"],
        speaker=seg["speaker"], language="en", alignment=alignment)


def prepare_oto_speech(
    corpus_dir: Pathlike, output_dir: Pathlike, parts: Tuple[str, ...] = ("train",),
    target_sr: int = 16000,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Unpack shards, build lazily-resampled recordings + pseudo supervisions."""
    corpus_dir = Path(corpus_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    labels_path = corpus_dir / "seglst.json"
    if not labels_path.exists():
        raise FileNotFoundError(
            f"Labels not found at {labels_path}. Place the release's seglst.json there.")
    label_data = json.loads(labels_path.read_text(encoding="utf-8"))

    manifests = {}
    for part in parts:
        if part != "train":
            logging.warning(
                f"Preparing split '{part}', but standard otoSpeech only guarantees 'train'.")
        part_dir = corpus_dir / "data" / part
        unpacked_dir = part_dir / "unpacked"
        unpacked_dir.mkdir(parents=True, exist_ok=True)
        for tar_path in sorted(part_dir.glob("*.tar")):
            extract_and_flatten_tar(tar_path, unpacked_dir)

        recordings = RecordingSet.from_recordings(
            Recording.from_file(p) for p in sorted(unpacked_dir.glob("*.flac")))
        recordings = recordings.resample(target_sr)

        supervisions = []
        for idx, seg in enumerate(label_data):
            if seg["session_id"] not in recordings:
                continue
            if round(seg["end_time"] - seg["start_time"], 4) <= 0:
                logging.warning(
                    f"Skipped segment for rec: {seg['session_id']} at "
                    f"{seg['start_time']} due to 0 duration")
                continue
            supervisions.append(_segment_from_label(seg, idx))
        supervision_set = SupervisionSet.from_segments(supervisions)
        recordings, supervision_set = fix_manifests(recordings, supervision_set)
        recordings.to_file(output_dir / f"oto_recordings_{part}.jsonl.gz")
        supervision_set.to_file(output_dir / f"oto_supervisions_{part}.jsonl.gz")
        manifests[part] = {"recordings": recordings, "supervisions": supervision_set}
    return manifests
