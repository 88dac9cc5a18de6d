"""
TAL-ASR recipe (copied from ``lhotse_tpu/recipes/tal_asr.py``): about 100 h
of Mandarin classroom speech, 16 kHz WAV under ``aisolution_data/wav/
{train,dev,test}/<speaker>/``, one transcript file for every split
(``aisolution_data/transcript/transcript.txt``). The corpus is obtained
manually (https://ai.100tal.com/dataset).
"""
import logging
import re
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._zh_common import build_part_manifests, maybe_store
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

# Punctuation dropped by the upstream wenet prep script.
_STRIP = re.compile("#|=|、|，|？|。|[|]")


def text_normalize(line: str) -> str:
    """TAL-ASR normalization (fullwidth A, strip marks, uppercase)."""
    return _STRIP.sub("", line.replace("Ａ", "A")).upper()


def read_tal_transcripts(path: Path, normalize) -> Dict[str, str]:
    """``<utt-id> <text...>`` lines -> normalized utt->text table."""
    table = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            table[fields[0]] = normalize(" ".join(fields[1:]))
    return table


def prepare_tal_asr(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """TAL-ASR train/dev/test manifests off the aisolution_data tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    root = corpus_dir / "aisolution_data"
    transcripts = read_tal_transcripts(
        root / "transcript" / "transcript.txt", text_normalize)

    manifests = {}
    for part in ("train", "dev", "test"):
        logging.info(f"Processing tal_asr subset: {part}")
        wavs = (root / "wav" / part).rglob("**/*.wav")
        part_manifests = build_part_manifests(
            wavs, transcripts, speaker_of=lambda p: p.parts[-2])
        maybe_store(part_manifests, output_dir, "tal_asr", part)
        manifests[part] = part_manifests
    return manifests
