"""
DailyTalk recipe (copied from ``lhotse_tpu/recipes/daily_talk.py``): 2,541
recorded two-speaker dialogues for conversational TTS
(https://github.com/keonlee9420/DailyTalk)::

    dailytalk/
      metadata.json    # {dialog_idx: {utt_idx: {index, text, speaker, turn, ...}}}
      data/**/<utt>_<speaker>_d<dialog>.wav

The download, which goes through ``gdown``, is not ported.
"""
from pathlib import Path
from typing import Tuple

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.serialization import load_json
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def make_recording_id(path: Path) -> str:
    return f"dailytalk_{path.stem}"


def prepare_daily_talk(
    corpus_dir: Pathlike, output_dir: Pathlike = None, num_jobs: int = 1,
) -> Tuple[RecordingSet, SupervisionSet]:
    """
    DailyTalk manifests.  Dialogue metadata (turn/topic/emotion/act) lands in
    ``supervision.custom``; returns ``(recordings, supervisions)`` to mirror
    the reference's signature for this recipe.
    """
    corpus_dir = Path(corpus_dir)
    recordings = RecordingSet.from_dir(
        corpus_dir / "data", "*.wav", num_jobs=num_jobs, recording_id=make_recording_id)

    supervisions = []
    for dialog_idx, dialog in load_json(corpus_dir / "metadata.json").items():
        for utt_idx, utt in dialog.items():
            if utt["speaker"] not in (0, 1):
                raise AssertionError(f"Unknown speaker index: {utt['speaker']}")
            rec_id = f"dailytalk_{utt_idx}_{utt['speaker']}_d{dialog_idx}"
            supervisions.append(
                SupervisionSegment(
                    id=f"dailytalk_{utt['index']}",
                    recording_id=rec_id,
                    start=0.0,
                    duration=recordings[rec_id].duration,
                    channel=0,
                    text=utt["text"],
                    language="English",
                    speaker=f"dailytalk_spk{utt['speaker']}",
                    gender="F" if utt["speaker"] == 1 else "M",
                    custom={k: utt[k] for k in ("turn", "topic", "emotion", "act")},
                )
            )

    recordings, supervisions = fix_manifests(recordings, SupervisionSet.from_segments(supervisions))
    validate_recordings_and_supervisions(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(exist_ok=True, parents=True)
        recordings.to_file(output_dir / "dailytalk_recordings_all.jsonl.gz")
        supervisions.to_file(output_dir / "dailytalk_supervisions_all.jsonl.gz")
    return recordings, supervisions
