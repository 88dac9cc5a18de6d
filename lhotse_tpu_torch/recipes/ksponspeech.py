"""
KsponSpeech recipe (copied from ``lhotse_tpu/recipes/ksponspeech.py``): 969 h
of spontaneous Korean dialogue with dual orthography/pronunciation
transcripts (https://www.mdpi.com/2076-3417/10/19/6936). Each part has a
``{part}.trn`` table of ``path :: text`` rows over headerless 16 kHz int16
``.pcm`` files, which are converted to FLAC next to their source by the
package's own FLAC encoder. ``normalize`` strips the noise labels ``x/``,
keeps the spelling side of ``(spelling)/(pronunciation)`` pairs and drops
``*``, ``+`` and ``/``. The corpus is downloaded by hand from the AI-Hub
portal, so there is no download.
"""
import logging
import re
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

KSPONSPEECH = ("train", "dev", "eval_clean", "eval_other")

_NOISE_LABEL = re.compile(r"[a-z]/")
_DUAL_TRANSCRIPT = re.compile(r"\((.*?)\)/\((.*?)\)")


def normalize(raw_content: str, normalize_text: str = "default") -> Tuple[str, str]:
    """Split a ``.trn`` row into (file name, text); optionally clean the text."""
    if len(raw_content) == 0:
        return ""
    content_id, content = raw_content.split(" :: ")
    if normalize_text == "none":
        return content_id, content
    content = _NOISE_LABEL.sub("", content)
    content = _DUAL_TRANSCRIPT.sub(r"\1", content)  # keep the spelling side
    for ch in ("*", "+", "/"):
        content = content.replace(ch, "")
    return content_id, re.sub(r"\s+", " ", content).strip()


def pcm_to_flac(
    pcm_path: Pathlike, flac_path: Pathlike, sample_rate: Optional[int] = 16000,
    channels: Optional[int] = 1, bit_depth: Optional[int] = 16) -> Path:
    """Convert a headerless 16-bit PCM file to FLAC (skips if already done).
    The samples are scaled by 1/32768, which the encoder's rounding of
    ``x * 32768`` inverts exactly."""
    pcm_path = Path(pcm_path)
    flac_path = Path(flac_path)
    if flac_path.is_file():
        return flac_path
    assert bit_depth == 16, "Only 16-bit KsponSpeech PCM is supported."
    samples = np.fromfile(pcm_path, dtype="<i2")
    if channels > 1:
        samples = samples.reshape(-1, channels).T
    else:
        samples = samples[np.newaxis, :]
    write_flac(flac_path, samples.astype(np.float32) / 32768.0, sample_rate)
    return flac_path


def parse_utterance(
    corpus_dir: Pathlike, part: str, line: str, normalize_text: str = "default",
) -> Optional[Tuple[Recording, SupervisionSegment]]:
    corpus_dir = Path(corpus_dir)
    audio_path, text = normalize(line.strip(), normalize_text)
    if "eval" in part:
        # eval .trn rows carry a leading "KsponSpeech_eval/" component
        audio_path = audio_path.split("/", maxsplit=1)[1]
    audio_path = corpus_dir / audio_path
    if not audio_path.is_file():
        logging.warning(f"No such file: {audio_path}")
        return None
    recording_id = audio_path.stem
    flac_path = pcm_to_flac(audio_path, audio_path.with_suffix(".flac"))
    recording = Recording.from_file(flac_path, recording_id=recording_id)
    segment = SupervisionSegment(
        id=recording_id, recording_id=recording_id, start=0.0,
        duration=recording.duration, channel=0, language="Korean", text=text)
    return recording, segment


def prepare_ksponspeech(
    corpus_dir: Pathlike, dataset_parts: Union[str, Sequence[str]] = "all",
    output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
    normalize_text: str = "default",
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-part manifests off the ``{part}.trn`` tables + converted FLACs.
    ``num_jobs`` is accepted and not used."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if dataset_parts == "all":
        dataset_parts = KSPONSPEECH
    elif isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]
    manifests = read_manifests_if_cached(
        dataset_parts=dataset_parts, output_dir=output_dir, prefix="ksponspeech",
        suffix="jsonl.gz", lazy=True) or {}

    for part in dataset_parts:
        if manifests_exist(
                part=part, output_dir=output_dir, prefix="ksponspeech", suffix="jsonl.gz"):
            logging.info(f"KsponSpeech subset: {part} already prepared - skipping.")
            continue
        logging.info(f"Processing KsponSpeech subset: {part}")
        recordings, supervisions = [], []
        for line in (corpus_dir / f"{part}.trn").read_text().splitlines():
            if not line.strip():
                continue
            parsed = parse_utterance(corpus_dir, part, line, normalize_text)
            if parsed is None:
                continue
            recording, segment = parsed
            recordings.append(recording)
            supervisions.append(segment)
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir, prefix="ksponspeech",
            part=part)
    return manifests
