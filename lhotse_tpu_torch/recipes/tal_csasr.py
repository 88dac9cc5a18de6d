"""
TAL-CSASR recipe (copied from ``lhotse_tpu/recipes/tal_csasr.py``): about
587 h of Mandarin-English code-switching speech, 16 kHz WAV under
``TALCS_corpus/{train_set,dev_set,test_set}/wav/`` with a ``label.txt`` per
split; the speaker is the utterance id. The corpus is obtained manually
(https://ai.100tal.com/dataset).
"""
import logging
import re
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes._zh_common import build_part_manifests, maybe_store
from lhotse_tpu_torch.recipes.tal_asr import read_tal_transcripts
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_STRIP = re.compile('#|[=]|；|，|？|。|[/]|！|[!]|[.]|[?]|：|,|"|:|@|-|、|~|《|》|[|]|、|\\.')
_FULLWIDTH = str.maketrans("ＡＣＤＧＨＵＹＩＥＮａ", "ACDGHUYIENa")


def text_normalize(line: str) -> str:
    """TAL-CSASR normalization (fullwidth letters, strip marks, uppercase)."""
    return _STRIP.sub("", line.translate(_FULLWIDTH)).upper()


def prepare_tal_csasr(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """TAL-CSASR train_set/dev_set/test_set manifests off the TALCS_corpus
    tree (``num_jobs`` is accepted as in the JAX package and not used)."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    root = corpus_dir / "TALCS_corpus"
    parts = ("train_set", "dev_set", "test_set")
    transcripts = {}
    for part in parts:
        label_file = root / part / "label.txt"
        if label_file.is_file():
            transcripts.update(read_tal_transcripts(label_file, text_normalize))

    manifests = {}
    for part in parts:
        logging.info(f"Processing tal_csasr subset: {part}")
        wavs = (root / part / "wav").rglob("**/*.wav")
        part_manifests = build_part_manifests(wavs, transcripts, speaker_of=lambda p: p.stem)
        maybe_store(part_manifests, output_dir, "tal_csasr", part)
        manifests[part] = part_manifests
    return manifests
