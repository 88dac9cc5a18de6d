"""
CHiME-6 (copied from ``lhotse_tpu/recipes/chime6.py``): dinner-party
conversations recorded with binaural headsets (ihm) and six 4-channel
Kinect arrays (mdm), 20 sessions.

Expected layout, the *array-synchronised* CHiME-6 distribution::

    CHiME6/
      audio/{train,dev,eval}/S??_P??.wav      # binaural headsets (2ch each)
      audio/{train,dev,eval}/S??_U0?.CH?.wav  # array channels
      transcriptions/{train,dev,eval}/S??.json

Each transcription entry has HH:MM:SS.mmm start/end times, speaker, words,
and (dev/eval) the reference array. The mic variants, the CHiME-7 split
option and the text-normalisation modes are the JAX package's.

Not ported: ``download_chime6`` (it needs the network), and the array
synchroniser that makes the synchronised layout from the raw CHiME-5 one
(``Chime6ArraySynchronizer`` with ``verify_md5_checksums``): it fetches
its edit metadata and checksum list by URL unless given local copies, and
wants a sox v14.4.2 binary for bit-exact warps. ``prepare_chime6`` raises
``NotImplementedError`` for ``perform_array_sync=True`` and
``verify_md5_checksums=True``; both wait for ROADMAP.md A6.
"""
import json
import logging
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet, info as audio_info
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, add_durations

SESSIONS = {
    "train": ["S03", "S04", "S05", "S06", "S07", "S08", "S12", "S13", "S16", "S17", "S18", "S19", "S20", "S22", "S23", "S24"],
    "dev": ["S02", "S09"], "eval": ["S01", "S21"]}
# CHiME-7 moved the S19/S20 train sessions into eval.
SESSIONS_CHIME7 = {
    "train": [s for s in SESSIONS["train"] if s not in ("S19", "S20")],
    "dev": ["S02", "S09"], "eval": ["S01", "S19", "S20", "S21"]}
# The names upstream lhotse gives these splits.
DATASET_PARTS = SESSIONS
DATASET_PARTS_CHIME7 = SESSIONS_CHIME7


def hms_to_seconds(stamp: str) -> float:
    """'HH:MM:SS.mmm' -> seconds."""
    h, m, s = stamp.split(":")
    return int(h) * 3600 + int(m) * 60 + float(s)


def seconds_to_hms(seconds: float) -> str:
    """seconds -> 'HH:MM:SS.mmm' (millisecond precision, like the corpus
    JSONs).  Rounds to whole milliseconds FIRST so fractional carry can never
    emit an invalid seconds field like '60.000' (upstream lhotse's plain
    f-string formatting can)."""
    total_ms = round(seconds * 1000)
    h, rem = divmod(total_ms, 3_600_000)
    m, ms = divmod(rem, 60_000)
    return f"{h:02d}:{m:02d}:{ms / 1000:06.3f}"


def normalize_text_chime6(text: str, normalize: str = "upper") -> str:
    """Text normalization modes matching Kaldi's CHiME-6 recipe."""
    if normalize == "none":
        return text
    if normalize == "upper":
        return text.upper()
    if normalize == "kaldi":
        if "[redacted]" in text:
            return ""
        text = text.lower()
        text = re.sub(r"[.?,:;!]", "", text)
        text = re.sub(r"\s+", " ", text)
        text = re.sub(r"\[inaudible[- 0-9]*\]", "[inaudible]", text)
        text = re.sub(r" - ", " ", text)
        text = text.replace("mm-", "mm")
        return text.strip()
    raise ValueError(f"Unknown CHiME-6 text normalization mode: {normalize}")


def _headset_recording(session: str, wavs: list):
    """One binaural-headset Recording per session; returns (rec, spk->channels)."""
    spk_channels = {}
    sources = []
    for idx, wav in enumerate(wavs):
        pair = [2 * idx, 2 * idx + 1]
        sources.append(AudioSource(type="file", channels=pair, source=str(wav)))
        spk_channels[wav.stem.split("_")[1]] = pair
    meta = audio_info(wavs[0])
    rec = Recording(
        id=session, sources=sources, sampling_rate=int(meta.samplerate), num_samples=meta.frames,
        duration=meta.frames / meta.samplerate)
    return rec, spk_channels


def _array_recording(session: str, wavs: list) -> Recording:
    sources = [
        AudioSource(type="file", channels=[idx], source=str(wav)) for idx,
        wav in enumerate(sorted(wavs))]
    meta = audio_info(sorted(wavs)[0])
    return Recording(
        id=session, sources=sources, sampling_rate=int(meta.samplerate), num_samples=meta.frames,
        duration=meta.frames / meta.samplerate)


def prepare_chime6(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    dataset_parts: Optional[Union[str, Sequence[str]]] = "all", mic: str = "mdm",
    use_reference_array: bool = False, perform_array_sync: bool = False,
    verify_md5_checksums: bool = False, num_jobs: int = 1, num_threads_per_job: int = 1,
    sox_path: Pathlike = "/usr/bin/sox", use_chime7_split: bool = False,
    normalize_text: str = "kaldi") -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Build CHiME-6 manifests from an array-synchronized corpus directory.

    :param mic: "ihm" (binaural headsets, one multi-source Recording per
        session) or "mdm" (all array channels in one Recording).
    :param use_reference_array: in mdm dev/eval, restrict each supervision's
        channels to its annotated reference array.
    :param use_chime7_split: apply the CHiME-7 re-split (S19/S20 move from
        train into eval).
    :param perform_array_sync: not ported; True raises ``NotImplementedError``.
    :param verify_md5_checksums: not ported; True raises ``NotImplementedError``.
    :param num_jobs: taken for the JAX signature; used only by the array sync.
    :param num_threads_per_job: taken for the JAX signature; used only by the
        array sync.
    :param sox_path: taken for the JAX signature; used only by the array sync.
    :param normalize_text: "none" | "upper" | "kaldi".
    """
    corpus_dir = Path(corpus_dir)
    if mic not in ("ihm", "mdm"):
        raise AssertionError(f"mic must be 'ihm' or 'mdm', got {mic!r}")
    split = SESSIONS_CHIME7 if use_chime7_split else SESSIONS
    if dataset_parts == "all" or "all" in dataset_parts:
        dataset_parts = list(split)
    elif isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]
    unknown = set(dataset_parts) - set(split)
    if unknown:
        raise AssertionError(f"Unknown CHiME-6 parts: {sorted(unknown)}")

    if perform_array_sync or verify_md5_checksums:
        raise NotImplementedError(
            "The port has no CHiME-6 array synchroniser and no checksum check "
            "(perform_array_sync, verify_md5_checksums): they wait for ROADMAP.md A6. "
            "Prepare an already synchronised corpus.")

    use_reference_array = use_reference_array and mic == "mdm"

    def session_home(part: str, session: str) -> str:
        # CHiME-7 eval sessions S19/S20 physically live under train/.
        if use_chime7_split and session in ("S19", "S20"):
            return "train"
        return part

    manifests = defaultdict(dict)
    for part in dataset_parts:
        recordings = []
        headset_channels: Dict[tuple, list] = {}
        for session in split[part]:
            home = session_home(part, session)
            if mic == "ihm":
                wavs = sorted((corpus_dir / "audio" / home).rglob(f"{session}_P*.wav"))
                if not wavs:
                    raise FileNotFoundError(
                        f"No headset audio for session {session} in {home} set."
                    )
                rec, spk_map = _headset_recording(session, wavs)
                for spk, chans in spk_map.items():
                    headset_channels[(session, spk)] = chans
            else:
                wavs = sorted((corpus_dir / "audio" / home).rglob(f"{session}_U*.wav"))
                if not wavs:
                    raise FileNotFoundError(f"No array audio for session {session} in {home} set.")
                rec = _array_recording(session, wavs)
            recordings.append(rec)
        recordings = RecordingSet.from_recordings(recordings)

        def channels_for(session, spk, ref=None):
            if mic == "ihm":
                return headset_channels[(session, spk)]
            rec = recordings[session]
            if ref is None:
                return list(range(rec.num_channels))
            return [i for i, s in enumerate(rec.sources) if ref in s.source]

        supervisions = []
        for session in split[part]:
            home = session_home(part, session)
            transcript_path = corpus_dir / "transcriptions" / home / f"{session}.json"
            for idx, seg in enumerate(json.loads(transcript_path.read_text())):
                begin = hms_to_seconds(seg["start_time"])
                finish = hms_to_seconds(seg["end_time"])
                if begin >= finish:
                    continue  # a few annotations have non-positive durations
                want_ref = (seg.get("ref") if use_reference_array and part != "train" else None)
                supervisions.append(
                    SupervisionSegment(
                        id=f"{session}-{idx}",
                        recording_id=session,
                        start=begin,
                        duration=add_durations(finish, -begin, sampling_rate=16000),
                        channel=channels_for(session, seg["speaker"], want_ref),
                        text=normalize_text_chime6(seg["words"], normalize=normalize_text),
                        language="English",
                        speaker=seg["speaker"],
                        custom=(
                            {"location": seg["location"]}
                            if part != "train" and "location" in seg
                            else None
                        ),
                    )
                )
        supervisions = SupervisionSet.from_segments(supervisions)

        recordings, supervisions = fix_manifests(recordings, supervisions)
        validate_recordings_and_supervisions(recordings, supervisions)
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            mic_affix = f"{mic}-ref" if use_reference_array else mic
            supervisions.to_file(output_dir / f"chime6-{mic_affix}_supervisions_{part}.jsonl.gz")
            recordings.to_file(output_dir / f"chime6-{mic}_recordings_{part}.jsonl.gz")
        manifests[part] = {"recordings": recordings, "supervisions": supervisions}
        logging.info(f"CHiME-6 {part}/{mic}: {len(recordings)} sessions prepared.")
    return dict(manifests)
