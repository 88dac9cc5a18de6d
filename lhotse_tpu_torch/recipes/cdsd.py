"""
CDSD recipe (copied from ``lhotse_tpu/recipes/cdsd.py``): the Chinese
Dysarthric Speech Database, about 34 h from 24 dysarthric speakers (one
speaker adds a 10 h part; https://arxiv.org/abs/2310.15930v1). Parts
``1h`` and ``10h`` under ``after_catting/``, each with ``Audio/<speaker>/
*.wav`` and ``Text/*.txt`` transcript shards; spaces are removed from the
stored text. The corpus is obtained manually.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._zh_common import build_part_manifests, maybe_store
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_FULLWIDTH = str.maketrans("ａｂｃｋｔ", "abckt")


def text_normalize(line: str) -> str:
    """Fullwidth latin -> ascii, uppercase (the upstream aishell-style prep)."""
    return line.translate(_FULLWIDTH).upper()


def _read_transcript_shards(text_dir: Path) -> Dict[str, str]:
    table = {}
    for text_path in sorted(text_dir.rglob("**/*.txt")):
        with open(text_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                idx, content = line.strip().split(maxsplit=1)
                # intra-word spaces are dropped from the stored text
                table[idx] = text_normalize(content).replace(" ", "")
    return table


def prepare_cdsd(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Build the ``1h`` and ``10h`` part manifests off the after_catting tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"

    manifests = {}
    for part in ("1h", "10h"):
        logging.info(f"Processing CDSD subset: {part}")
        part_dir = corpus_dir / "after_catting" / part
        transcripts = _read_transcript_shards(part_dir / "Text")
        wavs = (part_dir / "Audio").rglob("**/*.wav")
        part_manifests = build_part_manifests(
            wavs, transcripts, speaker_of=lambda p: p.parts[-2])
        maybe_store(part_manifests, output_dir, "cdsd", part)
        manifests[part] = part_manifests
    return manifests
