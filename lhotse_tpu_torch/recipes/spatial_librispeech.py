"""
Spatial LibriSpeech (copied from
``lhotse_tpu/recipes/spatial_librispeech.py``): Apple's ambisonics
re-render of LibriSpeech, 4-channel FLAC under ``audio_files/{train,test}``
with a parquet metadata table (per-sample transcription, reader and
acoustics). Supervisions come from the LibriSpeech columns of the table,
optionally lower-cased. Reading the parquet needs pandas (with pyarrow).
``download_spatial_librispeech`` is not ported: it needs the network.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, is_module_available

SPATIAL_LIBRISPEECH = ("train", "test")


def _require_pandas():
    if not is_module_available("pandas"):
        raise ImportError(
            "The Spatial LibriSpeech recipe requires pandas + pyarrow to parse the "
            "parquet metadata. Install them with: pip install pandas pyarrow")
    import pandas as pd

    return pd


def _stem(path: Path) -> str:
    # A function of the module, not a lambda: ``from_dir`` spawns its workers.
    return path.stem


def _resolve_parts(dataset_parts) -> Sequence[str]:
    if dataset_parts == "all":
        return SPATIAL_LIBRISPEECH
    parts = [dataset_parts] if isinstance(dataset_parts, str) else list(dataset_parts)
    for part in parts:
        assert part in SPATIAL_LIBRISPEECH, f"Unknown dataset part: {part}"
    return parts


def prepare_spatial_librispeech(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    dataset_parts: Union[str, Sequence[str]] = SPATIAL_LIBRISPEECH,
    normalize_text: str = "none", num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """train/test manifests off the ambisonics flacs + parquet metadata."""
    pd = _require_pandas()
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    output_dir = Path(output_dir) if output_dir is not None else corpus_dir
    output_dir.mkdir(parents=True, exist_ok=True)
    dataset_parts = _resolve_parts(dataset_parts)
    metadata_path = corpus_dir / "metadata.parquet"
    assert metadata_path.is_file(), f"{metadata_path} not found"
    metadata = pd.read_parquet(metadata_path)

    manifests = {}
    for part in dataset_parts:
        logging.info(f"Processing {part} split...")
        recording_set = RecordingSet.from_dir(
            corpus_dir / "audio_files" / part, pattern="*.flac", num_jobs=num_jobs,
            recording_id=_stem)
        supervisions = []
        for _, row in metadata[metadata["split"] == part].iterrows():
            recording_id = f"{row['sample_id']:06}"
            recording = recording_set[recording_id]
            text = row["speech/librispeech_metadata/transcription"]
            if normalize_text == "lower":
                text = text.lower()
            supervisions.append(
                SupervisionSegment(
                    id=recording_id, recording_id=recording_id, start=0,
                    duration=recording.duration, channel=recording.channel_ids,
                    text=text, gender=row["speech/librispeech_metadata/reader_sex"],
                    speaker=row["speech/librispeech_metadata/reader_id"]))
        manifests[part] = finalize_manifests(
            recording_set, supervisions, output_dir=output_dir,
            prefix="spatial-librispeech", part=part)
    return manifests
