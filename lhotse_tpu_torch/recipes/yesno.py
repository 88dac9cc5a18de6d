"""
YesNo corpus recipe (openslr/1; copied from ``lhotse_tpu/recipes/yesno.py``):
60 8 kHz WAV files of eight Hebrew yes/no words each, the transcript
encoded in the file name (0 = no, 1 = yes).

The sorted files alternate between the splits: even indices train, odd
indices test. ``download_yesno`` is not ported: it needs the network.
"""
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_WORD_MAP = {"0": "NO", "1": "YES"}


def _make_manifests(wavs: List[Path],) -> Tuple[RecordingSet, SupervisionSet]:
    recordings, supervisions = [], []
    for audio_path in wavs:
        words = audio_path.stem.split("_")
        assert len(words) == 8 and set(words) <= {"0", "1"}, (
            f"Unexpected yesno filename: {audio_path.name}"
        )
        recording = Recording.from_file(audio_path.absolute())
        recordings.append(recording)
        supervisions.append(
            SupervisionSegment(
                id=audio_path.stem,
                recording_id=audio_path.stem,
                start=0.0,
                duration=recording.duration,
                channel=0,
                language="Hebrew",
                text=" ".join(_WORD_MAP[w] for w in words),
            )
        )
    rs, ss = fix_manifests(
        RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))
    validate_recordings_and_supervisions(rs, ss)
    return rs, ss


def prepare_yesno(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Train/test manifests: the sorted files alternate between the splits
    (30/30 on the real 60-file corpus)."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    wavs = sorted(corpus_dir.glob("*.wav"))
    splits = {"train": wavs[::2], "test": wavs[1::2]}

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    manifests = {}
    for part, files in splits.items():
        if not files:
            continue
        recordings, supervisions = _make_manifests(files)
        if output_dir is not None:
            recordings.to_file(output_dir / f"yesno_recordings_{part}.jsonl.gz")
            supervisions.to_file(output_dir / f"yesno_supervisions_{part}.jsonl.gz")
        manifests[part] = {"recordings": recordings, "supervisions": supervisions}
    return manifests
