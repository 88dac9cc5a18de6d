"""
BUT Speech@FIT Reverb Database (copied from
``lhotse_tpu/recipes/but_reverb_db.py``): real room impulse responses and
environmental noises from 9 rooms. The parts ``silence`` and ``rir`` are
chosen by the name of each WAV file's parent directory; recording ids are
built from the room, microphone, speaker and utterance path components
and a version suffix.

``download_but_reverb_db`` is not ported: it needs the network.
"""
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.utils import Pathlike


def prepare_but_reverb_db(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    parts: Sequence[str] = ("silence", "rir"),
) -> Dict[str, Dict[str, Union[RecordingSet, CutSet]]]:
    """Per-part recording manifests (RIRs and room noises)."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if not parts:
        raise ValueError("No parts specified for manifest preparation.")
    if isinstance(parts, str):
        parts = [parts]

    by_part = defaultdict(list)
    for wav_file in sorted(corpus_dir.rglob("*.wav")):
        part = wav_file.parent.name.lower()
        if part not in parts:
            continue
        room_id = wav_file.parent.parent.parent.parent.parent.stem
        mic_id = wav_file.parent.parent.parent.parent.stem
        spk_id = wav_file.parent.parent.parent.stem
        uid = wav_file.parent.parent.stem
        version = wav_file.stem.split(".")[-1]
        by_part[part].append(
            Recording.from_file(
                wav_file, recording_id=f"{room_id}-{mic_id}-{spk_id}-{uid}-v{version}"))

    manifests = {
        part: {"recordings": RecordingSet.from_recordings(by_part[part])}
        for part in parts}
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for part in parts:
            manifests[part]["recordings"].to_file(
                output_dir / f"but-reverb-db_{part}_recordings.jsonl.gz")
    return manifests
