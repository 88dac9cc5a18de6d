"""
MDCC recipe (the Multi-Domain Cantonese Corpus; copied from
``lhotse_tpu/recipes/mdcc.py``): 73.6 h of read Cantonese from Hong Kong
audiobooks, 16 kHz WAV; the language code is "yue". ``download_mdcc`` (a
Google Drive fetch through ``gdown``) is not ported: it needs the network.

Layout::

    dataset/
      audio/*.wav
      cnt_asr_{train,valid,test}_metadata.csv   # audio_path,text_path,gender,duration
      transcription/*.txt
"""
import logging
from pathlib import Path
from typing import Dict, Sequence, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

MDCC_PARTS = ("train", "valid", "test")


def make_recording_id(path: Path) -> str:
    return f"mdcc_{path.stem}"


def prepare_mdcc(
    corpus_dir: Pathlike, dataset_parts: Union[str, Sequence[str]] = "all",
    output_dir: Pathlike = None) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-split MDCC manifests; a split whose metadata has no rows is left out."""
    corpus_dir = Path(corpus_dir)
    audio_dir = corpus_dir / "audio"
    if not audio_dir.is_dir():
        raise AssertionError(f"Missing {audio_dir} in {corpus_dir}.")
    if dataset_parts == "all" or (not isinstance(dataset_parts, str) and dataset_parts[0] == "all"):
        dataset_parts = MDCC_PARTS
    elif isinstance(dataset_parts, str):
        if dataset_parts not in MDCC_PARTS:
            raise AssertionError(f"Unknown dataset part: {dataset_parts}")
        dataset_parts = [dataset_parts]

    manifests = {}
    for part in dataset_parts:
        metadata = corpus_dir / f"cnt_asr_{part}_metadata.csv"
        if not metadata.is_file():
            raise AssertionError(f"Missing {part} metadata in {corpus_dir}.")
        recordings, supervisions = [], []
        for row in metadata.read_text().splitlines()[1:]:
            if not row.strip():
                continue
            audio_rel, text_rel, gender, _ = row.strip().split(",")
            wav = audio_dir / Path(audio_rel).name
            rec = Recording.from_file(wav, recording_id=make_recording_id(wav))
            recordings.append(rec)
            supervisions.append(
                SupervisionSegment(
                    id=rec.id,
                    recording_id=rec.id,
                    start=0.0,
                    duration=rec.duration,
                    channel=0,
                    text=(corpus_dir / text_rel).read_text().strip(),
                    gender=gender,
                    language="yue",
                )
            )
        if not recordings:
            logging.warning(f"MDCC part {part} has no rows; skipping.")
            continue
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir, prefix="mdcc", part=part)
    return manifests
