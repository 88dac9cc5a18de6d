"""
AISHELL-1 recipe (openslr/33; copied from ``lhotse_tpu/recipes/aishell.py``):
170 h of Mandarin read speech, 16 kHz WAV.

One transcript file, ``data_aishell/transcript/aishell_transcript_v0.8.txt``,
serves every split; the audio lies under ``data_aishell/wav/{train,dev,test}/
<speaker>/<utt>.wav``. Fullwidth latin letters are mapped to ASCII and the
spaces between Mandarin words removed. ``download_aishell`` is not ported:
it needs the network.
"""
import logging
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_FULLWIDTH = str.maketrans("ａｂｃｋｔ", "abckt")


def text_normalize(line: str) -> str:
    """Map fullwidth latin letters to ASCII and uppercase (the WeNet-style
    normalization)."""
    return line.translate(_FULLWIDTH).upper()


def prepare_aishell(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Prepare train/dev/test manifests from an extracted AISHELL-1 tree."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    transcript_path = (corpus_dir / "data_aishell/transcript/aishell_transcript_v0.8.txt")
    transcript_dict = {}
    with open(transcript_path, encoding="utf-8") as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            transcript_dict[fields[0]] = text_normalize(" ".join(fields[1:]))

    manifests = defaultdict(dict)
    for part in ("train", "dev", "test"):
        logging.info(f"Processing aishell subset: {part}")
        recordings, supervisions = [], []
        wav_path = corpus_dir / "data_aishell" / "wav" / part
        for audio_path in sorted(wav_path.rglob("**/*.wav")):
            idx = audio_path.stem
            if idx not in transcript_dict:
                logging.warning(f"{audio_path} has no transcript.")
                continue
            recording = Recording.from_file(audio_path)
            recordings.append(recording)
            supervisions.append(
                SupervisionSegment(
                    id=idx,
                    recording_id=idx,
                    start=0.0,
                    duration=recording.duration,
                    channel=0,
                    language="Chinese",
                    speaker=audio_path.parts[-2],
                    # No spaces between Mandarin words in the final text.
                    text=transcript_dict[idx].strip().replace(" ", ""),
                )
            )
        recording_set, supervision_set = fix_manifests(
            RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))
        validate_recordings_and_supervisions(recording_set, supervision_set)
        if output_dir is not None:
            recording_set.to_file(output_dir / f"aishell_recordings_{part}.jsonl.gz")
            supervision_set.to_file(output_dir / f"aishell_supervisions_{part}.jsonl.gz")
        manifests[part] = {"recordings": recording_set, "supervisions": supervision_set}
    return dict(manifests)
