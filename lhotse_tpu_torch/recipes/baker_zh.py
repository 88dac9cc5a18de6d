"""
Baker recipe (BZNSYP; copied from ``lhotse_tpu/recipes/baker_zh.py``): 12 h of
one female Mandarin voice, 48 kHz WAV under ``Wave/``, with prosody-labelled
transcripts. ``ProsodyLabeling/000001-010000.txt`` alternates an
``<id> <text>`` line and a pinyin line; the prosody marks ``#1``-``#5`` are
stripped into ``custom["normalized_text"]`` and the pinyin is kept in
``custom["pinyin"]``. There is one split, "all". ``download_baker_zh`` is
not ported: it needs the network.
"""
import logging
import re
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_PROSODY_MARKS = re.compile("#[12345]")


def _iter_label_pairs(labeling_file: Path):
    """The prosody file alternates (id + text) and pinyin lines."""
    lines = [ln.strip() for ln in labeling_file.read_text(encoding="utf-8").splitlines()]
    for text_line, pinyin in zip(lines[0::2], lines[1::2]):
        recording_id, original_text = text_line.split(None, maxsplit=1)
        yield recording_id, original_text, pinyin


def prepare_baker_zh(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Build the single-part (``all``) manifests off the BZNSYP tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    labeling_file = corpus_dir / "ProsodyLabeling" / "000001-010000.txt"
    if not labeling_file.is_file():
        raise ValueError(f"{labeling_file} does not exist")

    recordings, supervisions = [], []
    for recording_id, original_text, pinyin in _iter_label_pairs(labeling_file):
        audio_path = corpus_dir / "Wave" / f"{recording_id}.wav"
        if not audio_path.is_file():
            logging.warning(f"No such file: {audio_path}")
            continue
        recording = Recording.from_file(audio_path)
        recordings.append(recording)
        supervisions.append(
            SupervisionSegment(
                id=recording_id, recording_id=recording_id, start=0.0,
                duration=recording.duration, channel=0, language="Chinese", gender="female",
                text=original_text,
                custom={
                    "pinyin": pinyin,
                    "normalized_text": _PROSODY_MARKS.sub("", original_text)}))
    return finalize_manifests(
        recordings, supervisions, output_dir=output_dir, prefix="baker_zh", part="all")
