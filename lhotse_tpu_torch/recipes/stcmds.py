"""
ST-CMDS recipe (openslr/38; copied from ``lhotse_tpu/recipes/stcmds.py``):
100 h of Mandarin commands and short messages, 16 kHz WAV, one ``.txt``
transcript beside each file; the speaker is characters 8-15 of the id.
``download_stcmds`` is not ported: it needs the network.
"""
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._zh_common import build_part_manifests, maybe_store
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def text_normalize(line: str) -> str:
    """Drop fullwidth commas and uppercase (the WeNet-style normalization)."""
    return line.replace("，", "").upper()


def prepare_stcmds(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """One "train" split from an extracted ST-CMDS tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    path = corpus_dir / "ST-CMDS-20170001_1-OS"
    transcript_dict = {
        p.stem: text_normalize(p.read_text(encoding="utf-8").strip())
        for p in path.rglob("**/*.txt")
    }
    manifests = build_part_manifests(
        path.rglob("**/*.wav"),
        transcript_dict,
        # e.g. 20170001P00001A0001 -> speaker P00001A
        speaker_of=lambda p: p.stem[8:15],
    )
    maybe_store(manifests, output_dir, "stcmds", "train")
    return {"train": manifests}
