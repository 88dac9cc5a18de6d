"""
ICMC-ASR recipe (copied from ``lhotse_tpu/recipes/icmcasr.py``): the in-car
Mandarin ASR challenge data (https://icmcasr.org), recorded in a hybrid
electric vehicle with a near-field headset per seat (``DA01``..``DA04``),
four distributed far-field mics (``DX0{1-4}C01``) and linear arrays. Each
section directory holds a seat's ``DA0k.TextGrid`` of one tier; ``ihm``
pairs it with the seat's headset, ``sdm`` with each of the four DX
channels, and ``mdm`` with one ``Recording`` of the four DX files. ``ihm``
covers train and dev only. TextGrids are read by ``recipes/textgrid.py``
and texts normalised as AliMeeting's.
"""
import logging
import os
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet, info
from lhotse_tpu_torch.recipes.ali_meeting import normalize_text_alimeeting
from lhotse_tpu_torch.recipes.textgrid import read_textgrid
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

ICMCASR = ("train", "dev", "eval_track1")
POSITION = ("DA01", "DA02", "DA03", "DA04")
SDM_POSITION = ("DX01C01", "DX02C01", "DX03C01", "DX04C01")


def _audio_variants(corpus_dir: Path, section_path: Path, position: str, mic: str):
    """(audio_path, recording_id) pairs for one seat under the mic setup."""
    def rec_id(stem: str) -> str:
        return str(section_path / stem).replace(str(corpus_dir) + "/", "").replace("/", "-")

    if mic == "ihm":
        return [((section_path / f"{position}.wav").resolve(), rec_id(position))]
    if mic == "sdm":
        return [
            ((section_path / f"{sdm}.wav").resolve(), f"{rec_id(sdm)}-{position}")
            for sdm in SDM_POSITION]
    if mic == "mdm":
        return [(None, f"{rec_id('DXmixC01')}-{position}")]
    raise ValueError(f"Unsupported mic type: {mic}")


def _mdm_recording(section_path: Path, recording_id: str) -> Recording:
    channel_paths = [(section_path / f"{sdm}.wav").resolve() for sdm in SDM_POSITION]
    meta = info(channel_paths[0])
    return Recording(
        id=recording_id,
        sources=[
            AudioSource(type="file", channels=[idx], source=str(p))
            for idx, p in enumerate(channel_paths)],
        sampling_rate=16000, num_samples=meta.frames, duration=meta.duration)


def _parse_section(corpus_dir: Path, section_path: Path, mic: str):
    recordings, segments = [], []
    for position in POSITION:
        text_path = (section_path / f"{position}.TextGrid").resolve()
        if not text_path.is_file():
            continue
        for audio_path, recording_id in _audio_variants(
                corpus_dir, section_path, position, mic):
            if mic == "mdm":
                recordings.append(_mdm_recording(section_path, recording_id))
            else:
                if not audio_path.is_file():
                    logging.warning(f"Audio file {audio_path} does not exist - skipping.")
                    continue
                recordings.append(
                    Recording.from_file(path=audio_path, recording_id=recording_id))
            tiers = read_textgrid(text_path)
            assert len(tiers) == 1, f"Expected 1 tier, found {len(tiers)} tiers."
            tier = tiers[0]
            for interval in tier.intervals:
                if not interval.mark:
                    continue
                start, end = interval.minTime, interval.maxTime
                segments.append(
                    SupervisionSegment(
                        id=f"{recording_id}-{round(start * 1000):06}-{round(end * 1000):06}",
                        recording_id=recording_id, start=start,
                        duration=round(end - start, 4),
                        channel=0 if mic in ("sdm", "ihm") else list(range(4)),
                        language="Chinese", speaker=tier.name,
                        text=normalize_text_alimeeting(interval.mark)))
    return recordings, segments


def _prepare_subset(
    subset: str, corpus_dir: Path, mic: str, num_jobs: int = 1,
) -> Tuple[RecordingSet, SupervisionSet]:
    part_path = corpus_dir / subset
    recordings, segments = [], []
    for section in sorted(os.listdir(part_path)):
        recs, segs = _parse_section(corpus_dir, part_path / section, mic)
        recordings.extend(recs)
        segments.extend(segs)
    out = finalize_manifests(recordings, segments)
    return out["recordings"], out["supervisions"]


def prepare_icmcasr(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, mic: str = "ihm",
    num_jobs: int = 1) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-part manifests for the chosen mic setup (ihm/sdm/mdm). ``num_jobs``
    is accepted and not used."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    logging.info("Preparing ICMC-ASR...")
    subsets = ("train", "dev") if mic == "ihm" else ICMCASR
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    manifests = read_manifests_if_cached(
        dataset_parts=subsets, output_dir=output_dir, prefix=f"icmcasr-{mic}",
        suffix="jsonl.gz") or {}
    for part in subsets:
        if manifests_exist(
                part=part, output_dir=output_dir, prefix=f"icmcasr-{mic}",
                suffix="jsonl.gz"):
            logging.info(f"ICMC-ASR subset: {part} already prepared - skipping.")
            continue
        logging.info(f"Processing ICMC-ASR subset: {part}")
        recording_set, supervision_set = _prepare_subset(part, corpus_dir, mic, num_jobs)
        if output_dir is not None:
            supervision_set.to_file(
                output_dir / f"icmcasr-{mic}_supervisions_{part}.jsonl.gz")
            recording_set.to_file(
                output_dir / f"icmcasr-{mic}_recordings_{part}.jsonl.gz")
        manifests[part] = {"recordings": recording_set, "supervisions": supervision_set}
    return manifests
