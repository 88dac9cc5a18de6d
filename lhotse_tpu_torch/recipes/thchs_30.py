"""
THCHS-30 recipe (openslr/18; copied from ``lhotse_tpu/recipes/thchs_30.py``):
30 h of Mandarin read speech from Tsinghua, 16 kHz WAV.

Each ``data_thchs30/data/<utt>.wav.trn`` holds the character transcript on
its first line (pinyin and phones follow); the splits are the directories
``data_thchs30/{train,dev,test}``. ``download_thchs_30`` is not ported: it
needs the network.
"""
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._zh_common import build_part_manifests, maybe_store
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def text_normalize(line: str) -> str:
    return line.replace(" l =", "").upper()


def prepare_thchs_30(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Prepare train/dev/test manifests from an extracted THCHS-30 tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    data = corpus_dir / "data_thchs30" / "data"
    transcript_dict = {}
    for trn in data.rglob("**/*.wav.trn"):
        idx = Path(trn.stem).stem  # B11_374.wav.trn -> B11_374
        first_line = trn.read_text(encoding="utf-8").splitlines()[0]
        transcript_dict[idx] = text_normalize(first_line)

    manifests = {}
    for part in ("train", "dev", "test"):
        part_manifests = build_part_manifests(
            (corpus_dir / "data_thchs30" / part).rglob("**/*.wav"), transcript_dict,
            speaker_of=lambda p: p.stem.split("_")[0])
        maybe_store(part_manifests, output_dir, "thchs_30", part)
        manifests[part] = part_manifests
    return manifests
