"""
Primewords recipe (openslr/47; copied from ``lhotse_tpu/recipes/primewords.py``):
100 h of Mandarin smartphone recordings, 16 kHz WAV under
``primewords_md_2018_set1/audio_files``, and one JSON transcript table
(``set1_transcript.json``: file, text, user_id). ``download_primewords`` is
not ported: it needs the network.
"""
import json
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._zh_common import build_part_manifests, maybe_store
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def prepare_primewords(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """One "train" split from an extracted Primewords tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    root = corpus_dir / "primewords_md_2018_set1"
    transcript_path = root / "set1_transcript.json"
    assert transcript_path.is_file(), f"No such file: {transcript_path}"
    transcript_dict, speaker_dict = {}, {}
    for utt in json.loads(transcript_path.read_text(encoding="utf-8")):
        uttid = utt["file"].split(".")[0]
        transcript_dict[uttid] = utt["text"]
        speaker_dict[uttid] = str(utt["user_id"])

    manifests = build_part_manifests(
        (root / "audio_files").rglob("**/*.wav"), transcript_dict,
        speaker_of=lambda p: speaker_dict.get(p.stem))
    maybe_store(manifests, output_dir, "primewords", "train")
    return {"train": manifests}
