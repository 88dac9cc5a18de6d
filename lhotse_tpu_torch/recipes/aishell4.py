"""
AISHELL-4 (OpenSLR 111; copied from ``lhotse_tpu/recipes/aishell4.py``):
Mandarin meetings recorded with an 8-microphone array, FLAC sessions and
TextGrid annotations, splits ``train_{L,M,S}`` and ``test``.

Speaker ids in the TextGrids are local to a session; the recipe mints
globally unique ids per (session, local id) pair. ``download_aishell4``
is not ported: it needs the network.
"""
import logging
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.textgrid import read_textgrid
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

AISHELL4_PARTS = ("train_L", "train_M", "train_S", "test")

_FULLWIDTH = str.maketrans(
    {"Ａ": "A", "ａ": "A", "ｂ": "B", "ｃ": "C", "ｋ": "K", "ｔ": "T",
     "，": "", "丶": "", "。": "", "、": "", "？": ""}
)
_TAGS = ("<sil>", "<%>", "<->", "<$>", "<#>", "<_>", "<space>", "`", "&", ",", "\r", "\n")


def text_normalize(line: str) -> str:
    for tag in _TAGS:
        line = line.replace(tag, "")
    line = line.translate(_FULLWIDTH)
    if re.search("[a-zA-Z]", line):
        line = line.upper()
    return line


def prepare_aishell4(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, normalize_text: bool = False,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """AISHELL-4 manifests with globally unique speaker ids."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")

    global_speakers: Dict[tuple, str] = {}
    manifests = defaultdict(dict)
    for part in AISHELL4_PARTS:
        recordings, supervisions = [], []
        for flac in sorted((corpus_dir / part / "wav").rglob("*.flac")):
            session = flac.stem
            tg_path = corpus_dir / part / "TextGrid" / f"{session}.TextGrid"
            try:
                tiers = read_textgrid(tg_path)
            except (ValueError, FileNotFoundError):
                logging.warning(f"{session} has annotation issues; skipping.")
                continue
            rec = Recording.from_file(flac)
            recordings.append(rec)
            for tier in tiers:
                key = (session, tier.name)
                if key not in global_speakers:
                    global_speakers[key] = f"SPK{len(global_speakers) + 1:04d}"
                spk = global_speakers[key]
                for j, iv in enumerate(tier.intervals):
                    if not iv.mark:
                        continue
                    text = iv.mark.strip()
                    supervisions.append(
                        SupervisionSegment(
                            id=f"{session}-{spk}-{j}",
                            recording_id=session,
                            start=iv.minTime,
                            duration=round(iv.maxTime - iv.minTime, 4),
                            channel=rec.channel_ids,
                            language="Chinese",
                            speaker=spk,
                            text=text_normalize(text) if normalize_text else text,
                        )
                    )
        if not recordings:
            logging.warning(f"AISHELL-4 part {part} has no sessions; skipping.")
            continue
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir, prefix="aishell4", part=part)
    return dict(manifests)
