"""
AISHELL-3 recipe (openslr/93; copied from ``lhotse_tpu/recipes/aishell3.py``):
85 h of multi-speaker Mandarin TTS speech (218 speakers), 44.1 kHz WAV, with
Hanzi and pinyin transcripts and tone labels. ``download_aishell3`` is not
ported: it needs the network.

Layout::

    spk-info.txt                   # speaker \\t age-group \\t gender \\t region
    {train,test}/content.txt       # <wav-name>\\t<hanzi pinyin interleaved>
    train/label_train-set.txt      # <utt>|<tone pinyin>|<tone text>
    {train,test}/wav/<spk>/<utt>.wav
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

AISHELL3_PARTS = ("test", "train")


def _read_speaker_genders(path: Path) -> Dict[str, str]:
    genders = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        fields = line.split("\t")
        genders[fields[0]] = fields[2]
    return genders


def _read_tone_labels(path: Path) -> Dict[str, tuple]:
    tones = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        utt, tone_pinyin, tone_text = line.split("|")
        tones[utt] = (tone_pinyin, tone_text)
    return tones


def prepare_aishell3(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """AISHELL-3 manifests; pinyin and tone labels go to supervision.custom."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")

    manifests = {}
    if output_dir is not None:
        manifests = read_manifests_if_cached(
            dataset_parts=AISHELL3_PARTS, output_dir=output_dir, prefix="aishell3") or {}

    genders = _read_speaker_genders(corpus_dir / "spk-info.txt")
    tones = _read_tone_labels(corpus_dir / "train" / "label_train-set.txt")

    for part in AISHELL3_PARTS:
        if manifests_exist(part=part, output_dir=output_dir, prefix="aishell3"):
            logging.info(f"aishell3 subset: {part} already prepared - skipping.")
            continue
        part_dir = corpus_dir / part
        recordings, supervisions = [], []
        for line in (part_dir / "content.txt").read_text().splitlines():
            if not line.strip():
                continue
            wav_name, annotation = line.strip().split("\t")
            utt = wav_name.split(".")[0]
            speaker = utt[:7]
            wav = part_dir / "wav" / speaker / wav_name
            if not wav.is_file():
                logging.warning(f"No such file: {wav}")
                continue
            # content.txt interleaves hanzi and pinyin tokens.
            tokens = annotation.split()
            hanzi = "".join(tokens[0::2])
            pinyin = " ".join(tokens[1::2])
            tone_pinyin, tone_text = tones.get(utt, (None, None))
            rec = Recording.from_file(wav)
            recordings.append(rec)
            supervisions.append(
                SupervisionSegment(
                    id=utt,
                    recording_id=utt,
                    start=0.0,
                    duration=rec.duration,
                    channel=0,
                    language="Chinese",
                    speaker=speaker,
                    gender=genders.get(speaker, "female"),
                    text=hanzi,
                    custom={
                        "pinyin": pinyin.strip(),
                        "tones_pinyin": tone_pinyin,
                        "tones_text": tone_text,
                    },
                )
            )
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir, prefix="aishell3", part=part)
    return manifests
