"""
WenetSpeech4TTS recipe (copied from ``lhotse_tpu/recipes/wenetspeech4tts.py``):
Mandarin TTS corpora derived from WenetSpeech, in the nested quality tiers
Basic ⊃ Standard ⊃ Premium (https://arxiv.org/abs/2406.05763v3), 16 kHz WAV.

One ``filelists/Basic_filelist.lst`` lists every file with a path that
starts with ``../`` and resolves against ``corpus_dir``; the tier is in the
path. Each WAV has a sibling ``txts/<stem>.txt`` (a tab-separated text line
and a timestamp line), and ``DNSMOS_P808Scores/<tier>_DNSMOS.lst`` holds
each tier's scores. The corpus is obtained manually.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

WENETSPEECH4TTS = ("Basic", "Premium", "Standard")


def _read_pairs(path: Path) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            fields = line.strip().split()
            if len(fields) >= 2:
                out[fields[0]] = fields[1]
    return out


def _tier_wav_lists(corpus_dir: Path) -> Dict[str, Dict[str, str]]:
    """Split the master Basic filelist into the three nested quality tiers."""
    basic = _read_pairs(corpus_dir / "filelists" / "Basic_filelist.lst")
    return {
        "Basic": basic,
        "Standard": {k: v for k, v in basic.items() if "Basic" not in v},
        "Premium": {k: v for k, v in basic.items() if "Premium" in v}}


def prepare_wenetspeech4tts(
    corpus_dir: Pathlike, dataset_parts: Union[str, Sequence[str]] = "Basic",
    output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Build per-tier manifests; wav paths resolve relative to ``corpus_dir``
    (``num_jobs`` is accepted as in the JAX package and not used)."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"

    if dataset_parts == "all" or (len(dataset_parts) and dataset_parts[0] == "all"):
        dataset_parts = WENETSPEECH4TTS
    elif isinstance(dataset_parts, str):
        assert dataset_parts in WENETSPEECH4TTS, f"Unsupported dataset part: {dataset_parts}"
        dataset_parts = [dataset_parts]

    manifests = read_manifests_if_cached(
        dataset_parts=dataset_parts, output_dir=output_dir, prefix="wenetspeech4tts") or {}
    tier_wavs = _tier_wav_lists(corpus_dir)

    for part in dataset_parts:
        if manifests_exist(part=part, output_dir=output_dir, prefix="wenetspeech4tts"):
            logging.info(f"WenetSpeech4TTS subset: {part} already prepared - skipping.")
            continue
        mos = _read_pairs(corpus_dir / "DNSMOS_P808Scores" / f"{part}_DNSMOS.lst")
        recordings, supervisions = [], []
        for wav_name, listed_path in tier_wavs[part].items():
            if not listed_path.startswith("../"):
                raise AssertionError(f"Unexpected filelist path (no '../'): {listed_path}")
            wav_path = corpus_dir / listed_path[3:]
            if not wav_path.is_file():
                logging.warning(f"No such file: {wav_path}")
                continue
            txt_path = wav_path.parent.parent / "txts" / (wav_path.stem + ".txt")
            if not txt_path.is_file():
                logging.warning(f"No such file: {txt_path}")
                continue
            recording = Recording.from_file(wav_path)
            recordings.append(recording)
            text_line, timestamp = txt_path.read_text().splitlines()[:2]
            score = mos.get(wav_name)
            supervisions.append(
                SupervisionSegment(
                    id=wav_name, recording_id=wav_name, start=0.0,
                    duration=recording.duration, channel=0, language="Chinese",
                    text=text_line.strip().split("\t")[1],
                    custom={
                        "timestamp": timestamp.strip(),
                        "dns_mos": float(score) if score is not None else None}))
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir,
            prefix="wenetspeech4tts", part=part)
    return manifests
