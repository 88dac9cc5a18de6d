"""
GALE Arabic broadcast speech recipe (copied from
``lhotse_tpu/recipes/gale_arabic.py``): broadcast conversation and report
speech across the LDC GALE phases 2-4 (941 h train, 10.4 h test), 16 kHz
WAV or FLAC with TDF transcripts. Speech (``S``) and transcript (``T``)
corpora are passed in matched pairs; the test split is Kaldi's list of
recording ids.
"""
import logging
from itertools import chain
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes._tdf import tdf_supervisions
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob

# Kaldi test recordings (egs/gale_arabic/s5d/local/test/test_p2).
TEST = [
    "ALAM_WITHEVENT_ARB_20070116_205800",
    "ALAM_WITHEVENT_ARB_20070206_205801",
    "ALAM_WITHEVENT_ARB_20070213_205800",
    "ALAM_WITHEVENT_ARB_20070227_205800",
    "ALAM_WITHEVENT_ARB_20070306_205800",
    "ALAM_WITHEVENT_ARB_20070313_205800",
    "ARABIYA_FROMIRAQ_ARB_20070216_175800",
    "ARABIYA_FROMIRAQ_ARB_20070223_175801",
    "ARABIYA_FROMIRAQ_ARB_20070302_175801",
    "ARABIYA_FROMIRAQ_ARB_20070309_175800"]


def scan_gale_audio(audio_dirs: List[Pathlike]) -> Dict[str, Path]:
    """wav/flac files across all corpora, deduplicated by recording stem."""
    return {
        p.stem: p
        for p in chain.from_iterable(
            check_and_rglob(d, ext, strict=False)
            for d in audio_dirs
            for ext in ("*.wav", "*.flac"))}


def split_gale_manifests(recordings, supervisions, test_ids, parts, output_dir, prefix):
    """Partition by pinned test recording ids and optionally persist."""
    test_ids = set(test_ids)
    picks = {
        parts[0]: lambda rid: rid not in test_ids,
        parts[1]: lambda rid: rid in test_ids}
    manifests = {}
    for part, keep in picks.items():
        part_recs = recordings.filter(lambda r: keep(r.id))
        part_sups = supervisions.filter(lambda s: keep(s.recording_id))
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            part_recs.to_file(output_dir / f"{prefix}_recordings_{part}.jsonl.gz")
            part_sups.to_file(output_dir / f"{prefix}_supervisions_{part}.jsonl.gz")
        manifests[part] = {"recordings": part_recs, "supervisions": part_sups}
    return manifests


def prepare_gale_arabic(
    audio_dirs: List[Pathlike], transcript_dirs: List[Pathlike],
    output_dir: Optional[Pathlike] = None, absolute_paths: bool = True,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """train/test manifests off matched GALE speech + transcript corpora."""
    if len(audio_dirs) != len(transcript_dirs):
        raise AssertionError(
            "Paths to the same speech and transcript corpora must be provided")

    logging.info("Reading audio and transcript paths from provided dirs")
    audio_paths = scan_gale_audio(audio_dirs)
    transcript_paths = list(
        chain.from_iterable(check_and_rglob(d, "*.tdf") for d in transcript_dirs))

    logging.info("Preparing recordings and supervisions manifests")
    recordings = RecordingSet.from_recordings(
        Recording.from_file(p, relative_path_depth=None if absolute_paths else 3)
        for p in audio_paths.values())
    supervisions = SupervisionSet.from_segments(
        tdf_supervisions(transcript_paths, language="Arabic"))
    fixed = finalize_manifests(recordings, supervisions)

    return split_gale_manifests(
        fixed["recordings"], fixed["supervisions"], TEST, ("train", "test"),
        output_dir, "gale-arabic")
