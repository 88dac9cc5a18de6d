"""
CALLHOME Egyptian Arabic recipe (copied from
``lhotse_tpu/recipes/callhome_egyptian.py``): 120 unscripted two-channel
8 kHz telephone conversations in Cairene Arabic (speech LDC97S45,
transcripts LDC97T19), read from the romanized transcripts under
``callhome_arabic_trans_970711/transcrp/{split}/roman``. The LDC release
misspells the eval audio directory ``evltest``; supervision ids are
``{recording}_{index}``.
"""
import logging
from decimal import Decimal
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob

CALLHOME_EGYPTIAN_SPLITS = ("train", "devtest", "evaltest")


def prepare_callhome_egyptian(
    audio_dir: Pathlike, transcript_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    absolute_paths: bool = False) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Per-split manifests off the LDC97S45 audio + LDC97T19 transcripts."""
    audio_dir = Path(audio_dir)
    transcript_dir = Path(transcript_dir)

    manifests = {}
    for split in CALLHOME_EGYPTIAN_SPLITS:
        logging.info(f"Preparing CALLHOME Egyptian split: {split}")
        audio_paths = check_and_rglob(
            # the LDC distribution misspells the eval audio directory
            audio_dir / "callhome/arabic" / split.replace("evaltest", "evltest"), "*.sph")
        recordings = RecordingSet.from_recordings(
            Recording.from_file(p, relative_path_depth=None if absolute_paths else 4)
            for p in audio_paths)

        supervisions = []
        transcripts = check_and_rglob(
            transcript_dir / f"callhome_arabic_trans_970711/transcrp/{split}/roman", "*.txt")
        for p in transcripts:
            recording_id = p.stem
            idx = 0
            for line in p.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                # e.g. "19.33 21.18 B: %ah Tayyib"
                start, end, spk, text = line.split(maxsplit=3)
                spk = spk.replace(":", "")
                duration = float(Decimal(end) - Decimal(start))
                if duration <= 0:
                    continue
                supervisions.append(
                    SupervisionSegment(
                        id=f"{recording_id}_{idx}", recording_id=recording_id,
                        start=float(start), duration=duration,
                        speaker=f"{recording_id}_{spk}", text=text))
                idx += 1
        manifests[split] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir,
            prefix="callhome-egyptian", part=split)
    return manifests
