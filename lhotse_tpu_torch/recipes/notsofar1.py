"""
NOTSOFAR-1 (copied from ``lhotse_tpu/recipes/notsofar1.py``): Microsoft's
natural office meeting benchmark, with single-channel (``sc_*``),
multi-channel (``mc_*``) and close-talk device captures per meeting, and
ground-truth transcriptions with word timings.

``prepare_notsofar1`` walks ``benchmark-datasets/{part}/{version}/MTG`` and
writes sdm, mdm and ihm manifests; ``process_data`` maps the close-talk
files to speakers through ``gt_meeting_metadata.json``, wraps each
multi-channel device as a multi-source ``Recording`` and keeps the word
alignments minus ``<markup>`` tokens. ``download_notsofar1`` is not
ported: it needs the network.
"""
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Union

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.qa import fix_manifests
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def _listdir_safe(path: Pathlike) -> List[str]:
    return [name for name in os.listdir(path) if ".DS_Store" not in name]


def _word_alignment(segment: dict) -> dict:
    items = [
        AlignmentItem(symbol=w, start=float(s), duration=float(e) - float(s))
        for w, s, e in segment["word_timing"]
        if "<" not in w and ">" not in w]
    return {"word": items}


def _segment_sup(segment: dict, recording_id: str, channel, speaker: str,
                 create_word_alignment: bool) -> SupervisionSegment:
    start = float(segment["start_time"])
    end = float(segment["end_time"])
    return SupervisionSegment(
        id=f"{recording_id}_{int(start * 100):06d}_{int(end * 100):06d}",
        recording_id=recording_id, start=start, duration=end - start, channel=channel,
        text=segment["text"], speaker=speaker,
        alignment=_word_alignment(segment) if create_word_alignment else None)


def _close_talk_cuts(meeting: str, device_path: Path, transcription: list,
                     ct_device_to_speaker: dict, create_word_alignment: bool):
    cuts = []
    for ct_wav in sorted(f for f in _listdir_safe(device_path) if f.endswith(".wav")):
        ct_device_id = Path(ct_wav).stem  # e.g. "CT_21"
        speaker = ct_device_to_speaker.get(ct_device_id, ct_device_id)
        recording = Recording.from_file(device_path / ct_wav)
        recording.id = f"{meeting}_close_talk_{ct_device_id}"
        sups = [
            _segment_sup(seg, recording.id, 0, speaker, create_word_alignment)
            for seg in transcription if seg["speaker_id"] == speaker]
        cuts.append(
            MonoCut(
                id=recording.id, start=0, duration=recording.duration, channel=0,
                supervisions=sups, recording=recording))
    return cuts


def process_data(dataset_path: Path, word_level: bool = False,
                 create_word_alignment: bool = True):
    """(sc_cuts, mc_cuts, ihm_cuts) for one part/version MTG directory."""
    sc_cuts, mc_cuts, ihm_cuts = [], [], []
    for meeting in sorted(_listdir_safe(dataset_path)):
        meeting_root = dataset_path / meeting
        transcription = json.loads((meeting_root / "gt_transcription.json").read_text())
        metadata_path = meeting_root / "gt_meeting_metadata.json"
        ct_device_to_speaker = {}
        if metadata_path.exists():
            metadata = json.loads(metadata_path.read_text())
            ct_device_to_speaker = {
                v: k for k, v in metadata.get("ParticipantAliasToCtDevice", {}).items()}
        devices = sorted(
            d for d in _listdir_safe(meeting_root) if (meeting_root / d).is_dir())
        for device in devices:
            device_path = meeting_root / device
            if "close_talk" in device:
                ihm_cuts.extend(
                    _close_talk_cuts(
                        meeting, device_path, transcription, ct_device_to_speaker,
                        create_word_alignment))
                continue
            device_id = f"{meeting}_{device}"
            is_multi_channel = "mc" in device
            recording = Recording.from_file(device_path / "ch0.wav")
            recording.id = device_id
            if is_multi_channel:
                num_channels = len(_listdir_safe(device_path))
                recording.channel_ids = list(range(num_channels))
                recording.sources = [
                    AudioSource(
                        type="file", channels=[i], source=str(device_path / f"ch{i}.wav"))
                    for i in range(num_channels)]
            sups = [
                _segment_sup(
                    seg, device_id, recording.channel_ids, seg["speaker_id"],
                    create_word_alignment)
                for seg in transcription]
            bucket = mc_cuts if is_multi_channel else sc_cuts
            bucket.append(
                MonoCut(
                    id=device_id, start=0, duration=recording.duration,
                    channel=recording.channel_ids if is_multi_channel else 0,
                    supervisions=sups, recording=recording))
    return sc_cuts, mc_cuts, ihm_cuts


def prepare_notsofar1(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per part/version/mic manifests off benchmark-datasets/."""
    corpus_dir = Path(corpus_dir) / "benchmark-datasets"
    if output_dir is None:
        raise ValueError("output_dir must be provided")
    output_dir = Path(output_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    output_dir.mkdir(parents=True, exist_ok=True)

    manifests = {}
    for part in _listdir_safe(corpus_dir):
        part_dir = corpus_dir / part
        manifests[part] = {}
        for version in _listdir_safe(part_dir):
            version_dir = part_dir / version / "MTG"
            sc_cuts, mc_cuts, ihm_cuts = process_data(
                version_dir, word_level=False, create_word_alignment=True)
            manifests[part][version] = {}
            for mic_name, tag, cuts in (
                    ("single_channel", "sdm", sc_cuts),
                    ("multi_channel", "mdm", mc_cuts),
                    ("close_talk", "ihm", ihm_cuts)):
                if not cuts:
                    continue
                recs, sups = fix_manifests(*CutSet.from_cuts(cuts).decompose()[:2])
                prefix = f"notsofar1_{tag}_{part}_{version}"
                recs.to_file(output_dir / f"{prefix}_recordings.jsonl.gz")
                sups.to_file(output_dir / f"{prefix}_supervisions.jsonl.gz")
                manifests[part][version][mic_name] = {
                    "recordings": recs, "supervisions": sups}
    return manifests
