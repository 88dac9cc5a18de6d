"""
MiniLibriMix (copied from ``lhotse_tpu/recipes/librimix_mini.py``): the
small premixed LibriMix release on Zenodo, described by one metadata CSV
with per-mixture source, noise and mixture paths. The 'sources' manifests
always (two sources as channels 0 and 1 of one Recording), 'premixed' on
request, 'noise' when the CSV has a ``noise_path`` column; rows shorter
than ``min_segment_seconds`` are dropped. The CSV is parsed with the csv
module. ``download_librimix_mini`` is not ported: it needs the network.
"""
import csv
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, Seconds


def make_corresponding_supervisions(audio: RecordingSet) -> SupervisionSet:
    """Whole-recording placeholder supervisions, one per source channel."""
    return SupervisionSet.from_segments(
        SupervisionSegment(
            id=f"{recording.id}-c{source.channels[0]}", recording_id=recording.id,
            start=0.0, duration=recording.duration, channel=source.channels[0])
        for recording in audio
        for source in recording.sources)


def _recording_from_row(row: dict, sources: List[AudioSource], sampling_rate: int):
    length = int(float(row["length"]))
    return Recording(
        id=row["mixture_ID"], sources=sources, sampling_rate=sampling_rate,
        num_samples=length, duration=length / sampling_rate)


def _build_variant(
    rows: List[dict], make_sources, sampling_rate: int,
    min_segment_seconds: Seconds) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    recordings = RecordingSet.from_recordings(
        _recording_from_row(row, make_sources(row), sampling_rate)
        for row in rows
        if float(row["length"]) / sampling_rate > min_segment_seconds)
    supervisions = make_corresponding_supervisions(recordings)
    return finalize_manifests(recordings, supervisions)


def prepare_librimix_mini(
    librimix_csv: Pathlike, output_dir: Optional[Pathlike] = None,
    with_precomputed_mixtures: bool = False, sampling_rate: int = 16000,
    min_segment_seconds: Seconds = 3.0,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """sources/premixed/noise manifests off one MiniLibriMix metadata CSV."""
    librimix_csv = Path(librimix_csv)
    assert librimix_csv.is_file(), f"No such file: {librimix_csv}"
    with open(librimix_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    manifests = {}
    manifests["sources"] = _build_variant(
        rows,
        lambda row: [
            AudioSource(type="file", channels=[0], source=row["source_1_path"]),
            AudioSource(type="file", channels=[1], source=row["source_2_path"])],
        sampling_rate, min_segment_seconds)
    if output_dir is not None:
        manifests["sources"]["recordings"].to_file(
            output_dir / "librimix_recordings_sources.jsonl.gz")
        manifests["sources"]["supervisions"].to_file(
            output_dir / "librimix_supervisions_sources.jsonl.gz")

    if with_precomputed_mixtures:
        manifests["premixed"] = _build_variant(
            rows,
            lambda row: [AudioSource(type="file", channels=[0], source=row["mixture_path"])],
            sampling_rate, min_segment_seconds)
        if output_dir is not None:
            manifests["premixed"]["recordings"].to_file(
                output_dir / "librimix_recordings_mix.jsonl.gz")
            manifests["premixed"]["supervisions"].to_file(
                output_dir / "librimix_supervisions_mix.jsonl.gz")

    if rows and "noise_path" in rows[0]:
        manifests["noise"] = _build_variant(
            rows,
            lambda row: [AudioSource(type="file", channels=[0], source=row["noise_path"])],
            sampling_rate, min_segment_seconds)
        if output_dir is not None:
            manifests["noise"]["recordings"].to_file(
                output_dir / "librimix_recordings_noise.jsonl.gz")
            manifests["noise"]["supervisions"].to_file(
                output_dir / "librimix_supervisions_noise.jsonl.gz")
    return manifests
