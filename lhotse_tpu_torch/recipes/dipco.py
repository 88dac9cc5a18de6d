"""
DiPCo, the Dinner Party Corpus (copied from ``lhotse_tpu/recipes/dipco.py``):
dinner-party conversations captured by per-speaker close-talk microphones
and five 7-channel far-field arrays.

Layout::

    DiPCo/
      audio/{dev,eval}/S??_P??.wav        # close-talk (1ch per speaker)
      audio/{dev,eval}/S??_U??.CH?.wav    # arrays (5 x 7 = 35 channels)
      transcriptions/{dev,eval}/S??.json  # HH:MM:SS.ff times per device

``download_dipco`` is not ported: it needs the network.
"""
import json
from collections import defaultdict
from datetime import datetime as dt
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet, info as audio_info
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.chime6 import normalize_text_chime6
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, add_durations

SESSIONS = {"dev": ["S02", "S04", "S05", "S09", "S10"], "eval": ["S01", "S03", "S06", "S07", "S08"]}


def get_session_id(session: str, use_chime7_offset: bool = False) -> str:
    """CHiME-7 renumbers DiPCo sessions by +24 (after the CHiME-6 sessions)."""
    if not use_chime7_offset:
        return session
    return f"S{24 + int(session[1:]):02d}"


def _clock_to_seconds(stamp: str) -> float:
    return (dt.strptime(stamp, "%H:%M:%S.%f") - dt(1900, 1, 1)).total_seconds()


def _session_recording(session_id: str, sources: list, probe: Path) -> Recording:
    meta = audio_info(probe)
    return Recording(
        id=session_id, sources=sources, sampling_rate=int(meta.samplerate), num_samples=meta.frames,
        duration=meta.frames / meta.samplerate)


def prepare_dipco(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, mic: Optional[str] = "mdm",
    normalize_text: Optional[str] = "kaldi", use_chime7_offset: Optional[bool] = False,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    DiPCo manifests per part (dev/eval).

    :param mic: "ihm" (close-talk, one channel per speaker) or "mdm" (all 35
        array channels in one Recording).
    :param normalize_text: "none" | "upper" | "kaldi" (CHiME-6-style).
    """
    if mic not in ("ihm", "mdm"):
        raise AssertionError("mic must be one of 'ihm' or 'mdm'")
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    manifests = defaultdict(dict)
    for part in ("dev", "eval"):
        recordings = []
        speaker_channel: Dict[tuple, int] = {}
        for session in SESSIONS[part]:
            sid = get_session_id(session, use_chime7_offset)
            pattern = f"{session}_P*.wav" if mic == "ihm" else f"{session}_U*.wav"
            wavs = sorted((corpus_dir / "audio" / part).rglob(pattern))
            sources = []
            for idx, wav in enumerate(wavs):
                sources.append(AudioSource(type="file", channels=[idx], source=str(wav)))
                if mic == "ihm":
                    speaker_channel[(session, wav.stem.split("_")[1])] = idx
            recordings.append(_session_recording(sid, sources, wavs[0]))

        supervisions = []
        for session in SESSIONS[part]:
            sid = get_session_id(session, use_chime7_offset)
            transcript = json.loads(
                (corpus_dir / "transcriptions" / part / f"{session}.json").read_text()
            )
            for idx, seg in enumerate(transcript):
                spk = seg["speaker_id"]
                begin = _clock_to_seconds(seg["start_time"]["close-talk"])
                finish = _clock_to_seconds(seg["end_time"]["close-talk"])
                supervisions.append(
                    SupervisionSegment(
                        id=f"{sid}-{idx}",
                        recording_id=sid,
                        start=begin,
                        duration=add_durations(finish, -begin, sampling_rate=16000),
                        channel=(
                            speaker_channel[(session, spk)]
                            if mic == "ihm"
                            else list(range(35))
                        ),
                        text=normalize_text_chime6(seg["words"], normalize=normalize_text),
                        language="English",
                        speaker=spk,
                        gender=seg["gender"],
                        custom={
                            "nativeness": seg["nativeness"],
                            "mother_tongue": seg["mother_tongue"],
                        },
                    )
                )

        rec_set, sup_set = fix_manifests(
            RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))
        validate_recordings_and_supervisions(rec_set, sup_set)
        if output_dir is not None:
            sup_set.to_file(output_dir / f"dipco-{mic}_supervisions_{part}.jsonl.gz")
            rec_set.to_file(output_dir / f"dipco-{mic}_recordings_{part}.jsonl.gz")
        manifests[part] = {"recordings": rec_set, "supervisions": sup_set}
    return dict(manifests)
