"""
WenetSpeech recipe (copied from ``lhotse_tpu/recipes/wenet_speech.py``):
10,000+ hours of multi-domain Mandarin. One corpus-wide metadata file
describes every long recording and its segments, each segment tagged with
the subsets it belongs to (S ⊂ M ⊂ L for training; DEV, TEST_NET and
TEST_MEETING)::

    WenetSpeech.json      # audios[].{aid, path, duration,
                          #   segments[].{sid, begin_time, end_time, text, subsets}}
    audio/<split>/<domain>/<source>/<aid>.opus

No audio is read: each recording is built from the metadata at 16 kHz. The
release's audio is Opus; reading it needs the system Opus libraries.
"""
import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet
from lhotse_tpu_torch.parallel import parallel_map
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, add_durations, compute_num_samples

WENET_SPEECH_PARTS = ("L", "M", "S", "DEV", "TEST_NET", "TEST_MEETING")
# The name the reference recipe gives this tuple (with its typo).
WETNET_SPEECH_PARTS = WENET_SPEECH_PARTS


def parse_utterance(
    audio: Any, root_path: Path, subsets: Sequence[str],
) -> Tuple[Recording, Dict[str, List[SupervisionSegment]]]:
    """One metadata entry → its recording and, per requested subset, the
    segments tagged with it."""
    sampling_rate = 16000
    recording = Recording(
        id=audio["aid"],
        sources=[AudioSource(type="file", channels=[0],
                             source=str(Path(root_path) / audio["path"]))],
        num_samples=compute_num_samples(duration=audio["duration"], sampling_rate=sampling_rate),
        sampling_rate=sampling_rate, duration=audio["duration"])
    segments: Dict[str, List[SupervisionSegment]] = {sub: [] for sub in subsets}
    for seg in audio["segments"]:
        segment = SupervisionSegment(
            id=seg["sid"], recording_id=audio["aid"], start=seg["begin_time"],
            duration=add_durations(seg["end_time"], -seg["begin_time"],
                                   sampling_rate=sampling_rate),
            language="Chinese", text=seg["text"].strip())
        for sub in seg["subsets"]:
            if sub in segments:
                segments[sub].append(segment)
    return recording, segments


def prepare_wenet_speech(
    corpus_dir: Pathlike, dataset_parts: Union[str, Sequence[str]] = "all",
    output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-subset manifests from the corpus-wide JSON metadata, written as
    ``wenetspeech_{recordings,supervisions}_<part>.jsonl.gz``. An unknown
    part raises ``ValueError``."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]
    subsets = WENET_SPEECH_PARTS if "all" in dataset_parts else tuple(dataset_parts)
    for sub in subsets:
        if sub not in WENET_SPEECH_PARTS:
            raise ValueError(f"No such part of dataset in WenetSpeech: {sub}")

    raw_manifests_path = corpus_dir / "WenetSpeech.json"
    assert raw_manifests_path.is_file(), f"No such file: {raw_manifests_path}"
    logging.info(f"Loading raw manifests from: {raw_manifests_path}")
    raw_manifests = json.loads(raw_manifests_path.read_text(encoding="utf8"))

    collected = {sub: {"recordings": [], "supervisions": []} for sub in subsets}
    # Threads take the lambda; results come back in submission order.
    for recording, segments in parallel_map(
            lambda audio: parse_utterance(audio, corpus_dir, subsets), raw_manifests["audios"],
            num_jobs=num_jobs, threads=True):
        for part, segs in segments.items():
            if segs:
                collected[part]["recordings"].append(recording)
                collected[part]["supervisions"].extend(segs)

    manifests = defaultdict(dict)
    for sub in subsets:
        recordings, supervisions = fix_manifests(
            recordings=RecordingSet.from_recordings(collected[sub]["recordings"]),
            supervisions=SupervisionSet.from_segments(collected[sub]["supervisions"]))
        validate_recordings_and_supervisions(recordings, supervisions)
        if output_dir is not None:
            recordings.to_file(output_dir / f"wenetspeech_recordings_{sub}.jsonl.gz")
            supervisions.to_file(output_dir / f"wenetspeech_supervisions_{sub}.jsonl.gz")
        manifests[sub] = {"recordings": recordings, "supervisions": supervisions}
    return dict(manifests)
