"""
LJ Speech recipe (copied from ``lhotse_tpu/recipes/ljspeech.py``): 24 h of
one female speaker, 13,100 clips of 22,050 Hz WAV, in the public domain.

``metadata.csv`` has ``id|text|normalized`` rows; the normalized text goes
to ``custom["normalized_text"]``; there is one split, "all".
``download_ljspeech`` is not ported: it needs the network.
"""
import logging
import re
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, fastcopy


def prepare_ljspeech(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """One "all" split: {"recordings": ..., "supervisions": ...}."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    metadata_csv_path = corpus_dir / "metadata.csv"
    assert metadata_csv_path.is_file(), f"No such file: {metadata_csv_path}"
    recordings, supervisions = [], []
    with open(metadata_csv_path) as f:
        for line in f:
            recording_id, text, normalized = line.strip().split("|")
            audio_path = corpus_dir / "wavs" / f"{recording_id}.wav"
            if not audio_path.is_file():
                logging.warning(f"No such file: {audio_path}")
                continue
            recording = Recording.from_file(audio_path)
            recordings.append(recording)
            supervisions.append(
                SupervisionSegment(
                    id=recording_id,
                    recording_id=recording_id,
                    start=0.0,
                    duration=recording.duration,
                    channel=0,
                    language="English",
                    gender="female",
                    text=text,
                    custom={"normalized_text": normalized.strip()},
                )
            )
    recording_set, supervision_set = fix_manifests(
        RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))
    validate_recordings_and_supervisions(recording_set, supervision_set)
    if output_dir is not None:
        recording_set.to_file(output_dir / "ljspeech_recordings_all.jsonl.gz")
        supervision_set.to_file(output_dir / "ljspeech_supervisions_all.jsonl.gz")
    return {"recordings": recording_set, "supervisions": supervision_set}


def text_normalizer(segment: SupervisionSegment) -> SupervisionSegment:
    """Uppercase + strip punctuation from both text fields (the reference's
    TTS-prep helper, ljspeech.py:120-127)."""
    text = re.sub(r"[^\w !?]", "", segment.text.upper())
    normalized = re.sub(r"[^\w !?]", "", segment.custom["normalized_text"].upper())
    return fastcopy(segment, text=text, custom={"normalized_text": normalized})
