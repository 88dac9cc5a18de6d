"""
XBMU-AMDO31 recipe (copied from ``lhotse_tpu/recipes/xbmu_amdo31.py``): 31 h
of Amdo Tibetan read speech from Northwest Minzu University, 16 kHz WAV
under ``data/wav/{train,dev,test}/<speaker>/<speaker>-<utt>.wav``, with
``data/transcript/transcript_clean.txt`` keyed by the utterance id. The
supervision id is a running count and the utterance id; the language is
"tibetan". ``download_xbmu_amdo31`` (a ``git`` clone and untar) is not
ported: it needs the network.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def prepare_xbmu_amdo31(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Build train/dev/test manifests off an extracted XBMU-AMDO31 tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"

    transcripts = {}
    with open(corpus_dir / "data/transcript/transcript_clean.txt", encoding="utf-8") as f:
        for line in f:
            fields = line.split()
            if fields:
                transcripts[fields[0]] = " ".join(fields[1:])

    manifests = {}
    for part in ("train", "dev", "test"):
        logging.info(f"Processing xbmu_amdo31 subset: {part}")
        recordings, supervisions = [], []
        for count, audio_path in enumerate(
                sorted((corpus_dir / "data" / "wav" / part).rglob("**/*.wav")), start=1):
            # file names look like <speaker>-<uttid>.wav
            idx = audio_path.stem.split("-")[1]
            speaker = audio_path.parts[-2]
            if idx not in transcripts:
                logging.warning(f"{audio_path} has no transcript.")
                continue
            recording = Recording.from_file(audio_path)
            recordings.append(recording)
            supervisions.append(
                SupervisionSegment(
                    id=f"{count}_{idx}", recording_id=f"{speaker}-{idx}", start=0.0,
                    duration=recording.duration, channel=0, language="tibetan",
                    speaker=speaker, text=transcripts[idx].strip()))
        manifests[part] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir, prefix="xbmu_amdo31", part=part)
    return manifests
