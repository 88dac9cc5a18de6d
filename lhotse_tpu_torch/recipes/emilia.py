"""
Emilia recipe (copied from ``lhotse_tpu/recipes/emilia.py``): over 101k
hours of in-the-wild multilingual speech (de, en, fr, ja, ko, zh) from video
platforms and podcasts, CC BY-NC-4.0
(https://huggingface.co/datasets/amphion/Emilia-Dataset; access by
request). Each ``raw/{LANG}/*.jsonl`` row points at one clip, which becomes
one whole-clip ``MonoCut`` with its DNSMOS score in ``custom``. It has no
download.
"""
import logging
from pathlib import Path
from typing import Optional, Tuple

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.serialization import load_jsonl
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import Pathlike

EMILIA_LANGS = ("DE", "EN", "FR", "JA", "KO", "ZH")


def _parse_utterance(
    data_dir: Path, line: dict) -> Optional[Tuple[Recording, SupervisionSegment]]:
    full_path = data_dir / line["wav"]
    if not full_path.is_file():
        return None
    recording = Recording.from_file(path=full_path, recording_id=full_path.stem)
    segment = SupervisionSegment(
        id=recording.id, recording_id=recording.id, start=0.0,
        duration=recording.duration, channel=0, text=line["text"],
        language=line["language"], speaker=line["speaker"],
        custom={"dnsmos": line["dnsmos"]})
    return recording, segment


def prepare_emilia(
    corpus_dir: Pathlike, lang: str, num_jobs: int = 1,
    output_dir: Optional[Pathlike] = None) -> CutSet:
    """One whole-clip CutSet for the requested language's jsonl metadata."""
    if lang is None:
        raise ValueError("Please provide --lang")
    lang_uppercase = lang.upper()
    if lang_uppercase not in EMILIA_LANGS:
        raise ValueError(
            "Please provide a valid language. "
            f"Choose from de, en, fr, ja, ko, zh. Given: {lang}")
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    data_dir = corpus_dir / "raw" / lang_uppercase
    assert data_dir.is_dir(), f"No such directory: {data_dir}"

    cuts = []
    for jsonl_file in sorted(data_dir.glob("*.jsonl")):
        logging.info(f"Processing {jsonl_file}")
        for item in load_jsonl(jsonl_file):
            result = _parse_utterance(data_dir, item)
            if result is None:
                continue
            recording, segment = result
            cuts.append(
                MonoCut(
                    id=recording.id, recording=recording, start=0,
                    duration=recording.duration, supervisions=[segment], channel=0))
    cut_set = CutSet.from_cuts(cuts)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        cut_set.to_file(output_dir / f"emilia_cuts_{lang_uppercase}.jsonl.gz")
    return cut_set
