"""
EARS recipe (copied from ``lhotse_tpu/recipes/ears.py``): 100+ hours of
anechoic full-band (48 kHz) speech from 107 speakers (emotional speech,
reading styles, free speech) for speech enhancement and dereverberation
benchmarking (github.com/facebookresearch/ears_dataset)::

    p001/ .. p107/ *.wav        # per-speaker zips, utterance-style file stems
    speaker_statistics.json     # speaker -> {age, gender, native language, ...}
    transcripts.json            # utterance stem -> transcript (read styles)

An utterance without a transcript (free speech) gets ``text=None``. A
re-run with the manifests already in ``output_dir`` reads them back. The
download is not ported.
"""
import json
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

EARS_SPEAKERS = tuple(f"p{n:03d}" for n in range(1, 108))


class _SpeakerRecordingId:
    """Picklable path -> '<spk>_<stem>' mapper for RecordingSet.from_dir."""

    def __init__(self, spk: str):
        self.spk = spk

    def __call__(self, path: Path) -> str:
        return f"{self.spk}_{path.stem}"


def prepare_ears(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """One flat EARS manifest pair; speaker metadata in supervision.custom."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    # Cached re-run: return the previously written flat manifest pair.
    if output_dir is not None:
        rec_path = Path(output_dir) / "ears_recordings.jsonl.gz"
        sup_path = Path(output_dir) / "ears_supervisions.jsonl.gz"
        if rec_path.is_file() and sup_path.is_file():
            logging.info("EARS manifests already prepared - reading them back.")
            return {
                "recordings": RecordingSet.from_file(rec_path),
                "supervisions": SupervisionSet.from_file(sup_path),
            }
    spk2meta = json.loads((corpus_dir / "speaker_statistics.json").read_text())
    utt2text = json.loads((corpus_dir / "transcripts.json").read_text())

    recordings, supervisions = [], []
    for spk in EARS_SPEAKERS:
        spk_dir = corpus_dir / spk
        if not spk_dir.is_dir():
            continue
        recs = RecordingSet.from_dir(
            spk_dir, "*.wav", num_jobs=num_jobs, recording_id=_SpeakerRecordingId(spk))
        for rec in recs:
            recordings.append(rec)
            meta = dict(spk2meta[spk])
            utt = rec.id.split("_", 1)[1]
            supervisions.append(
                SupervisionSegment(
                    id=rec.id,
                    recording_id=rec.id,
                    start=0.0,
                    duration=rec.duration,
                    channel=0,
                    text=utt2text.get(utt),
                    language="English",
                    speaker=spk,
                    gender=meta.pop("gender", None),
                    custom=meta,
                )
            )
    result = finalize_manifests(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        result["supervisions"].to_file(output_dir / "ears_supervisions.jsonl.gz")
        result["recordings"].to_file(output_dir / "ears_recordings.jsonl.gz")
    return result
