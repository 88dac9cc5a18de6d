"""
aidatatang_200zh recipe (openslr/62; copied from
``lhotse_tpu/recipes/aidatatang_200zh.py``): 200 h of Mandarin from Beijing
DataTang, 16 kHz WAV under ``aidatatang_200zh/corpus/{train,dev,test}/
<speaker>/``, one shared transcript file. Fullwidth "Ａ" becomes "A" and the
text is uppercased. ``download_aidatatang_200zh`` (with its per-speaker
inner tars) is not ported: it needs the network.
"""
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._zh_common import build_part_manifests, maybe_store
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def prepare_aidatatang_200zh(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Prepare dev/test/train manifests; ``corpus_dir`` holds ``aidatatang_200zh/``."""
    corpus_dir = Path(corpus_dir)
    d = corpus_dir / "aidatatang_200zh"
    assert d.is_dir(), f"No such directory: {d}"
    transcript_path = d / "transcript" / "aidatatang_200_zh_transcript.txt"
    assert transcript_path.is_file(), f"No such file: {transcript_path}"
    transcript_dict = {}
    for line in transcript_path.read_text(encoding="utf-8").splitlines():
        fields = line.split()
        if not fields:
            continue
        content = " ".join(fields[1:]).replace("Ａ", "A").upper()
        transcript_dict[fields[0]] = content

    manifests = {}
    for part in ("dev", "test", "train"):
        part_manifests = build_part_manifests(
            (d / "corpus" / part).rglob("**/*.wav"), transcript_dict,
            speaker_of=lambda p: p.parts[-2])
        maybe_store(part_manifests, output_dir, "aidatatang_200zh", part)
        manifests[part] = part_manifests
    return manifests
