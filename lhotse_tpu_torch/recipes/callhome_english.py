"""
CALLHOME American English recipe (copied from
``lhotse_tpu/recipes/callhome_english.py``): 120 unscripted two-channel
8 kHz telephone conversations. It has two tasks: ASR (speech LDC97S42 and
transcripts LDC97T14, with the LDC ``evltest`` directory misspelling and
continuation-line stitching) and SRE/diarization (LDC2001S97 audio and
the NIST SRE-2000 RTTM key). ``download_callhome_metadata`` is not ported:
it needs the network, so the SRE task needs ``rttm_dir``.
"""
import logging
from collections import Counter
from decimal import Decimal, InvalidOperation
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob, not_ported

CALLHOME_ENGLISH_SPLITS = ("evaltest", "train", "devtest")


def read_rttm(path: Pathlike) -> SupervisionSet:
    """RTTM rows -> text-less supervisions (zero-duration rows dropped)."""
    sups = []
    seen = Counter()
    for line in Path(path).read_text().splitlines():
        _, recording_id, channel, start, duration, _, _, speaker, _, _ = line.split()
        if float(duration) == 0.0:
            continue
        seen[recording_id] += 1
        sups.append(
            SupervisionSegment(
                id=f"{recording_id}_{seen[recording_id]}", recording_id=recording_id,
                start=float(start), duration=float(duration), channel=int(channel),
                speaker=f"{recording_id}_{speaker}", language="English"))
    return SupervisionSet.from_segments(sups)


def _stitch_continuations(raw_lines: List[str]) -> List[str]:
    """CALLHOME transcript rows wrap: a line that does not start with a valid
    ``start end spk text`` quadruple continues the previous utterance."""
    rows: List[str] = []
    for line in (ln.strip() for ln in raw_lines):
        if not line or line.startswith("#"):
            continue
        try:
            start, end, _, _ = line.split(maxsplit=3)
            if float(Decimal(end) - Decimal(start)) <= 0:
                continue
            rows.append(line)
        except (InvalidOperation, ValueError):
            if rows:
                rows[-1] = rows[-1] + " " + line
    return rows


def _parse_transcript(path: Path, channel_from_speaker: bool) -> List[SupervisionSegment]:
    recording_id = path.stem
    segments = []
    for idx, line in enumerate(_stitch_continuations(path.read_text().splitlines())):
        # e.g. "19.33 21.18 B: %ah Tayyib"
        start, end, spk, text = line.split(maxsplit=3)
        spk = spk.replace(":", "")
        duration = float(Decimal(end) - Decimal(start))
        if duration <= 0:
            continue
        segments.append(
            SupervisionSegment(
                id=f"{recording_id}_{spk:0>2s}_{idx:0>5d}", recording_id=recording_id,
                start=float(start), duration=duration,
                channel=ord(spk[0]) - ord("A") if channel_from_speaker else 0,
                speaker=f"{recording_id}_{spk:0>2s}", text=text))
    return segments


def prepare_callhome_english(
    audio_dir: Pathlike, rttm_dir: Optional[Pathlike] = None,
    transcript_dir: Optional[Pathlike] = None, output_dir: Optional[Pathlike] = None,
    absolute_paths: bool = False) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """ASR manifests when ``transcript_dir`` is given, SRE/diarization otherwise."""
    if transcript_dir is not None:
        return prepare_callhome_english_asr(
            audio_dir, transcript_dir, output_dir, absolute_paths)
    return prepare_callhome_english_sre(audio_dir, rttm_dir, output_dir, absolute_paths)


def prepare_callhome_english_sre(
    audio_dir: Pathlike, rttm_dir: Optional[Pathlike] = None,
    output_dir: Optional[Pathlike] = None, absolute_paths: bool = False,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Diarization manifests off LDC2001S97 + the SRE-2000 RTTM key."""
    if rttm_dir is None:
        raise not_ported("Downloading the SRE-2000 RTTM key (download_callhome_metadata)")
    supervisions = read_rttm(Path(rttm_dir) / "fullref.rttm")
    recordings = RecordingSet.from_recordings(
        Recording.from_file(p, relative_path_depth=None if absolute_paths else 4)
        for p in check_and_rglob(audio_dir, "*.sph"))
    manifests = finalize_manifests(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        manifests["recordings"].to_json(output_dir / "recordings.json")
        manifests["supervisions"].to_json(output_dir / "supervisions.json")
    return manifests


def prepare_callhome_english_asr(
    audio_dir: Pathlike, transcript_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    absolute_paths: bool = False) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """ASR manifests off LDC97S42 (audio) + LDC97T14 (transcripts)."""
    audio_dir = Path(audio_dir)
    transcript_dir = Path(transcript_dir)
    manifests = {}
    for split in CALLHOME_ENGLISH_SPLITS:
        logging.info(f"Preparing CALLHOME English split: {split}")
        # the LDC distribution misspells the eval audio directory
        audio_paths = check_and_rglob(
            audio_dir / "data" / split.replace("evaltest", "evltest"), "*.sph")
        recordings = RecordingSet.from_recordings(
            Recording.from_file(p, relative_path_depth=None if absolute_paths else 4)
            for p in audio_paths)
        supervisions = []
        for p in check_and_rglob(transcript_dir / "transcrpt" / split, "*.txt"):
            supervisions.extend(_parse_transcript(p, channel_from_speaker=True))
        manifests[split] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir,
            prefix="callhome-english", part=split)
    return manifests
