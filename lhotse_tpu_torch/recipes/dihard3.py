"""
DIHARD III (LDC2020E12 dev / LDC2021E02 eval; copied from
``lhotse_tpu/recipes/dihard3.py``): a multi-domain diarization corpus with
FLAC audio, RTTM speaker annotations, UEM scoring regions and a
``recordings.tbl`` metadata table. LDC-licensed: there is no download.
"""
import logging
from collections import defaultdict
from itertools import chain
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def _find_one(root: Path, pattern: str) -> Path:
    hits = sorted(root.rglob(pattern))
    if not hits:
        raise FileNotFoundError(f"No {pattern} found under {root}")
    return hits[0]


def parse_metadata(metadata_path: Pathlike) -> Dict[str, Dict[str, Union[str, bool]]]:
    """recordings.tbl -> {recording_id: {in_core, lang, domain, source}}."""
    table = {}
    lines = Path(metadata_path).read_text().splitlines()
    for line in lines[1:]:  # header row first
        if not line.strip():
            continue
        rec_id, in_core, lang, domain, source = line.split()[:5]
        table[rec_id] = {
            "in_core": in_core == "True", "lang": lang, "domain": domain, "source": source}
    return table


def make_rttm_segments(
    rttm_path: Pathlike, recording: Recording, metadata: Dict) -> List[SupervisionSegment]:
    segments = []
    for row in Path(rttm_path).read_text().splitlines():
        fields = row.split()
        start, duration, speaker = float(fields[3]), float(fields[4]), fields[7]
        lo, hi = int(100 * start), int(100 * (start + duration))
        segments.append(
            SupervisionSegment(
                id=f"{recording.id}-{speaker}-{lo:06d}-{hi:06d}",
                recording_id=recording.id,
                start=start,
                duration=duration,
                speaker=speaker,
                language=metadata["lang"],
                custom=metadata,
            )
        )
    return segments


def make_uem_segments(uem_path: Pathlike, recording: Recording) -> List[SupervisionSegment]:
    segments = []
    for row in Path(uem_path).read_text().splitlines():
        _, _, start, end = row.split()
        start, end = float(start), float(end)
        segments.append(
            SupervisionSegment(
                id=f"{recording.id}-{int(100 * start):06d}-{int(100 * end):06d}",
                recording_id=recording.id,
                start=start,
                duration=round(end - start, ndigits=8),
            )
        )
    return segments


def prepare_dihard3(
    dev_audio_dir: Optional[Pathlike] = None, eval_audio_dir: Optional[Pathlike] = None,
    output_dir: Optional[Pathlike] = None, uem_manifest: Optional[bool] = True,
    num_jobs: Optional[int] = 1) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Build DIHARD III manifests for whichever of dev/eval directories exist.
    RTTM rows become speaker supervisions (with domain metadata in custom);
    with ``uem_manifest`` the UEM scoring regions are returned under "uem".
    """
    manifests = defaultdict(dict)
    for part, root in (("dev", dev_audio_dir), ("eval", eval_audio_dir)):
        if root is None or not Path(root).exists():
            logging.warning(f"Nothing to be done for {part}")
            continue
        root = Path(root)
        recordings = RecordingSet.from_dir(root, "*.flac", num_jobs=num_jobs)
        metadata = parse_metadata(_find_one(root, "recordings.tbl"))
        rttm_by_id = {p.stem: p for p in root.rglob("*.rttm")}
        uem_by_id = {p.stem: p for p in root.rglob("*.uem")}

        supervisions = SupervisionSet.from_segments(
            chain.from_iterable(
                make_rttm_segments(rttm_by_id[rec.id], rec, metadata[rec.id])
                for rec in recordings
            )
        )
        recordings, supervisions = fix_manifests(recordings, supervisions)
        validate_recordings_and_supervisions(recordings, supervisions)
        manifests[part] = {"recordings": recordings, "supervisions": supervisions}

        if uem_manifest:
            manifests[part]["uem"] = SupervisionSet.from_segments(
                chain.from_iterable(
                    make_uem_segments(uem_by_id[rec.id], rec) for rec in recordings
                )
            )

        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            recordings.to_file(output_dir / f"dihard3_recordings_{part}.jsonl.gz")
            supervisions.to_file(output_dir / f"dihard3_supervisions_{part}.jsonl.gz")
            if uem_manifest:
                manifests[part]["uem"].to_file(output_dir / f"dihard3_uem_{part}.jsonl.gz")
    return dict(manifests)
