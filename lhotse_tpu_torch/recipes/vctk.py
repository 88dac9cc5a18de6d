"""
CSTR VCTK recipe (copied from ``lhotse_tpu/recipes/vctk.py``): 110 English
speakers, one text file per utterance and a speaker-info table.

Two distributions: the CREST tarball with 48 kHz WAV under ``wav48``, and
Edinburgh's 0.92 zip with 48 kHz FLAC under ``wav48_silence_trimmed``, each
utterance once per microphone (``_mic1``, ``_mic2``). Speaker p280 has no
``mic2`` files and some p362 utterances no audio; both are skipped.
``speaker-info.txt`` gives age, gender, accent and region; there is one
split, "all". ``download_vctk`` and the distribution URLs are not ported:
they need the network.
"""
import logging
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def _parse_speaker_description(corpus_dir: Path, use_edinburgh_vctk_url: bool) -> Dict[str, dict]:
    rows = [line.split() for line in (corpus_dir / "speaker-info.txt").read_text().splitlines()]
    assert {"ID", "AGE", "GENDER", "ACCENTS", "REGION"} <= set(rows[0])
    meta = {}
    for spk, age, gender, accent, *region in rows[1:]:
        meta[spk if use_edinburgh_vctk_url else f"p{spk}"] = {
            "age": int(age), "gender": gender, "accent": accent, "region": " ".join(region) or None}
    return meta


def prepare_vctk(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    use_edinburgh_vctk_url: Optional[bool] = False, mic_id: Optional[str] = "mic2",
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """One "all" split: {"recordings": ..., "supervisions": ...}."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    speaker_meta = _parse_speaker_description(corpus_dir, use_edinburgh_vctk_url)

    if use_edinburgh_vctk_url:
        subdir, pattern = "wav48_silence_trimmed", "*.flac"
    else:
        subdir, pattern = "wav48", "*.wav"
    recordings = RecordingSet.from_recordings(
        Recording.from_file(p) for p in sorted((corpus_dir / subdir).rglob(pattern))
    )

    supervisions = []
    for path in sorted((corpus_dir / "txt").rglob("*.txt")):
        text = path.read_text().strip()
        speaker = path.name.split("_")[0]  # p226_001.txt -> p226
        seg_id = path.stem
        if use_edinburgh_vctk_url:
            # p280 has no mic2 recordings in the 0.92 distribution.
            if speaker == "p280" and mic_id == "mic2":
                continue
            audio_file_id = f"{seg_id}_{mic_id}"
        else:
            audio_file_id = seg_id
        if audio_file_id not in recordings:
            # Some p362 (and stray) utterances lack audio files.
            continue
        meta = speaker_meta.get(speaker)
        if meta is None:
            logging.warning(f"Cannot find metadata for speaker {speaker}.")
            meta = defaultdict(lambda: None)
        extras = {k: meta[k] for k in ("accent", "age", "region")}
        supervisions.append(
            SupervisionSegment(
                id=audio_file_id,
                recording_id=audio_file_id,
                start=0,
                duration=recordings[audio_file_id].duration,
                text=text,
                language="English",
                speaker=speaker,
                gender=meta["gender"],
                custom=extras,
            )
        )
    recordings, supervisions = fix_manifests(recordings, SupervisionSet.from_segments(supervisions))
    validate_recordings_and_supervisions(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        recordings.to_file(output_dir / "vctk_recordings_all.jsonl.gz")
        supervisions.to_file(output_dir / "vctk_supervisions_all.jsonl.gz")
    return {"recordings": recordings, "supervisions": supervisions}
