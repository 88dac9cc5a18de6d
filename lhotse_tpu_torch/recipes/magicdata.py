"""
MagicData recipe (openslr/68; copied from ``lhotse_tpu/recipes/magicdata.py``):
755 h of Mandarin read speech, 16 kHz WAV under ``<split>/<speaker>/``, with a
``TRANS.txt`` table per split (UtteranceID, SpeakerID, Transcription).
Punctuation and noise tokens are stripped (the WeNet-style normalization).
``download_magicdata`` is not ported: it needs the network.
"""
import re
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._zh_common import build_part_manifests, maybe_store
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

# Punctuation + noise tokens the WeNet prep strips.
_STRIP = re.compile("[！？，－：；。`,:?/·\"“”\\\\…、\\[\\]《》　﻿]|FIL|SPK|\\[ |《 ")


def text_normalize(line: str) -> str:
    return _STRIP.sub("", line).upper()


def prepare_magicdata(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Manifests of each split (train/dev/test) present in a MagicData tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    transcript_dict = {}
    for part in ("train", "dev", "test"):
        trans = corpus_dir / part / "TRANS.txt"
        if not trans.is_file():
            continue
        for line in trans.read_text(encoding="utf-8").splitlines():
            if line.startswith("UtteranceID"):
                continue
            fields = line.split()
            if len(fields) < 3:
                continue
            utt_id = fields[0].split(".")[0]
            transcript_dict[utt_id] = text_normalize(" ".join(fields[2:]))

    manifests = {}
    for part in ("train", "dev", "test"):
        wav_path = corpus_dir / part
        if not wav_path.is_dir():
            continue
        part_manifests = build_part_manifests(
            wav_path.rglob("**/*.wav"), transcript_dict, speaker_of=lambda p: p.parts[-2])
        maybe_store(part_manifests, output_dir, "magicdata", part)
        manifests[part] = part_manifests
    return manifests
