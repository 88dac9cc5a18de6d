"""
AMI Meeting Corpus recipe (copied from ``lhotse_tpu/recipes/ami.py``):
~100 h of meetings with close-talk headsets (IHM), their mix, single and
multiple distant microphones (SDM, MDM) and a beamformed array, with the
NXT manual annotations' word timings. ``parse_ami_annotations`` reads
``meetings.xml`` and the per-speaker segment and word XML files (a
directory or the annotations zip), ``split_segment`` re-segments turns on
full stops and commas, ``prepare_audio_grouped`` joins a session's
per-channel WAV files (headsets or the 8-channel array) into one
multi-source ``Recording``, and ``prepare_ami`` writes the official
partitions' manifests.

The downloads (``download_audio``, ``download_ami``) are not ported: they
need the network.
"""
import logging
import re
import xml.etree.ElementTree as ET
import zipfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, Seconds, add_durations

# Meeting ids per session; "a-d" expands to suffixed observations.
_SESSIONS: Dict[str, str] = {
    "EN2001": "abde", "EN2002": "abcd", "EN2003": "a", "EN2004": "a", "EN2005": "a", "EN2006": "ab",
    "EN2009": "bcd", **{f"ES20{i:02d}": "abcd" for i in range(2, 17)},
    **{f"IB40{i:02d}": "" for i in (1, 2, 3, 4, 5, 10, 11)},
    **{f"IN10{i:02d}": "" for i in (1, 2, 5, 7, 8, 9, 12, 13, 14, 16)}, "IS1000": "abcd",
    "IS1001": "abcd", "IS1002": "bcd", "IS1003": "abcd", "IS1004": "abcd", "IS1005": "abc",
    "IS1006": "abcd", "IS1007": "abcd", "IS1008": "abcd", "IS1009": "abcd",
    **{f"TS30{i:02d}": "abcd" for i in range(3, 13)}}

MEETINGS: Dict[str, List[str]] = {
    session: [session + suffix for suffix in suffixes] if suffixes else [session] for session,
    suffixes in _SESSIONS.items()}


def _expand(sessions: List[str], exclude: Tuple[str, ...] = ()) -> List[str]:
    return [m for s in sessions for m in MEETINGS[s] if m not in exclude]


_SCENARIO_TRAIN = [
    "ES2002", "ES2005", "ES2006", "ES2007", "ES2008", "ES2009", "ES2010", "ES2012", "ES2013",
    "ES2015", "ES2016", "IS1000", "IS1001", "IS1002", "IS1003", "IS1004", "IS1005", "IS1006",
    "IS1007", "TS3005", "TS3008", "TS3009", "TS3010", "TS3011", "TS3012"]
_NONSCENARIO_TRAIN = [
    "EN2001", "EN2003", "EN2004", "EN2005", "EN2006", "EN2009", "IN1001", "IN1002", "IN1005",
    "IN1007", "IN1008", "IN1009", "IN1012", "IN1013", "IN1014", "IN1016"]
_IB_DEV = ["IB4001", "IB4002", "IB4003", "IB4004", "IB4010", "IB4011"]

PARTITIONS = {
    "scenario-only": { "train": _expand(_SCENARIO_TRAIN, exclude=("IS1002a", "IS1005d")), "dev": _expand(["ES2003", "ES2011", "IS1008", "TS3004", "TS3006"]), "test": _expand(["ES2004", "ES2014", "IS1009", "TS3003", "TS3007"]), },
    "full-corpus": { "train": _expand(_SCENARIO_TRAIN + _NONSCENARIO_TRAIN), "dev": _expand(["ES2003", "ES2011", "IS1008", "TS3004", "TS3006"] + _IB_DEV), "test": _expand( ["ES2004", "ES2014", "IS1009", "TS3003", "TS3007", "EN2002"] ), },
    "full-corpus-asr": { "train": _expand( _SCENARIO_TRAIN + _NONSCENARIO_TRAIN + ["ES2014", "TS3007", "ES2003", "TS3006"] ), "dev": _expand(["ES2011", "IS1008", "TS3004"] + _IB_DEV), "test": _expand(["ES2004", "IS1009", "TS3003", "EN2002"]), },
}

MICS = ["ihm", "ihm-mix", "sdm", "mdm", "mdm8-bf"]
MDM_ARRAYS = ["Array1", "Array2"]
MDM_CHANNELS = [f"{i:02d}" for i in range(1, 9)]


def normalize_text_ami(text: str, normalize: str = "upper") -> str:
    """Kaldi-AMI-style text normalization (none / upper / kaldi)."""
    if normalize == "none":
        return text
    if normalize == "upper":
        return text.upper()
    if normalize == "kaldi":
        text = text.upper()
        text = re.sub(r"[^A-Z0-9']+", " ", text)
        text = re.sub(r"\s+", " ", text)
        # Frequent dashed interjections get dictionary-friendly forms.
        text = re.sub(r"MM HMM", "MM-HMM", text)
        text = re.sub(r"UH HUH", "UH-HUH", text)
        text = re.sub(r"(\b)O K(\b)", r"\g<1>OK\g<2>", text)
        text = re.sub(r"(\b)O_K(\b)", r"\g<1>OK\g<2>", text)
        return text.strip()
    raise ValueError(f"Unknown text normalization: {normalize}")


class AmiSegmentAnnotation(NamedTuple):
    text: str
    speaker: str
    gender: str
    start_time: Seconds
    end_time: Seconds
    words: List[AlignmentItem]


def split_segment(
    words: List[Tuple[float, float, str]], max_words_per_segment: Optional[int] = None,
    merge_consecutive: bool = False, keep_punctuation: bool = False,
) -> List[List[Tuple[float, float, str]]]:
    """
    Re-segment a speaker turn's word list on full stops (and, when a turn
    still exceeds ``max_words_per_segment``, on commas, greedily merging
    comma-chunks up to the limit). ``merge_consecutive`` re-joins adjacent
    full-stop chunks while they stay within the limit.
    """

    def chunks_on(sequence, sep):
        chunk = []
        for item in sequence:
            if item[-1] == sep:
                if keep_punctuation:
                    chunk.append(item)
                if chunk:
                    yield chunk
                chunk = []
            else:
                chunk.append(item)
        if chunk:
            yield chunk

    subsegs = list(chunks_on(words, "."))
    if len(subsegs) >= 2 and merge_consecutive:
        limit = max_words_per_segment or 100000
        merged = [subsegs[0]]
        for seg in subsegs[1:]:
            if (merged[-1][-1][1] == seg[0][0] and len(merged[-1]) + len(seg) <= limit):
                merged[-1].extend(seg)
            else:
                merged.append(seg)
        subsegs = merged

    if max_words_per_segment is not None:
        out = []
        for seg in subsegs:
            if len(seg) <= max_words_per_segment:
                out.append(seg)
                continue
            comma_chunks = list(chunks_on(seg, ","))
            if len(comma_chunks) < 2:
                out.extend(comma_chunks)
                continue
            merged = [comma_chunks[0]]
            for chunk in comma_chunks[1:]:
                if len(merged[-1]) + len(chunk) <= max_words_per_segment:
                    merged[-1].extend(chunk)
                else:
                    merged.append(chunk)
            out.extend(merged)
        subsegs = out
    return [s for s in subsegs if s]


def parse_ami_annotations(
    annotations_dir: Pathlike, normalize: str = "upper",
    max_words_per_segment: Optional[int] = None, merge_consecutive: bool = False,
    keep_punctuation: bool = False) -> Dict[Tuple[str, str, int], List[AmiSegmentAnnotation]]:
    annotations_dir = Path(annotations_dir)
    if str(annotations_dir).endswith(".zip"):
        with zipfile.ZipFile(annotations_dir) as z:
            z.extractall(path=annotations_dir.parent)
        annotations_dir = annotations_dir.parent

    # Global speaker name + headset channel per (meeting, local agent).
    global_spk_id, channel_id = {}, {}
    tree = ET.parse(annotations_dir / "corpusResources" / "meetings.xml")
    for meeting in tree.getroot():
        meet_id = meeting.attrib["observation"]
        for speaker in meeting:
            local = (meet_id, speaker.attrib["nxt_agent"])
            global_spk_id[local] = speaker.attrib["global_name"]
            channel_id[local] = int(speaker.attrib["channel"])

    # Speaker turn intervals.
    segments: Dict[Tuple[str, str, int], List[Tuple[float, float]]] = {}
    for file in sorted((annotations_dir / "segments").iterdir()):
        meet_id, local_spkid, _ = file.stem.split(".")
        if (meet_id, local_spkid) not in global_spk_id:
            logging.warning(f"No speaker {meet_id}.{local_spkid} found! Skipping annotation.")
            continue
        key = (meet_id, global_spk_id[(meet_id, local_spkid)], channel_id[(meet_id, local_spkid)])
        segments[key] = [
            (
                float(seg.attrib["transcriber_start"]),
                float(seg.attrib["transcriber_end"]),
            )
            for seg in ET.parse(file).getroot()
            if seg.tag == "segment"
        ]

    # Word-level timings.
    words: Dict[Tuple[str, str, int], List[Tuple[float, float, str]]] = {}
    for file in sorted((annotations_dir / "words").iterdir()):
        meet_id, local_spkid, _ = file.stem.split(".")
        if (meet_id, local_spkid) not in global_spk_id:
            continue
        key = (meet_id, global_spk_id[(meet_id, local_spkid)], channel_id[(meet_id, local_spkid)])
        if key not in segments:
            continue
        entries = []
        for word in ET.parse(file).getroot():
            if word.tag != "w" or "starttime" not in word.attrib:
                continue
            maybe_space = "" if word.get("punc", False) else " "
            maybe_hyphen = "- " if word.get("trunc", False) else ""
            entries.append(
                (
                    float(word.attrib["starttime"]),
                    float(word.attrib["endtime"]),
                    (maybe_space + word.text + maybe_hyphen)
                    if keep_punctuation
                    else word.text,
                )
            )
        words[key] = entries

    annotations = defaultdict(list)
    for key, segs in segments.items():
        spk_words = words.get(key, [])
        for seg_start, seg_end in segs:
            seg_words = [w for w in spk_words if w[0] >= seg_start and w[1] <= seg_end]
            for subseg in split_segment(
                seg_words, max_words_per_segment, merge_consecutive, keep_punctuation):
                start, end = subseg[0][0], subseg[-1][1]
                word_alignments = []
                for w in subseg:
                    w_start = max(start, round(w[0], ndigits=4))
                    w_end = min(end, round(w[1], ndigits=4))
                    w_dur = add_durations(w_end, -w_start, sampling_rate=16000)
                    w_symbol = normalize_text_ami(w[2], normalize=normalize)
                    if not w_symbol:
                        continue
                    if w_dur <= 0 and (not keep_punctuation or len(w[2]) > 1):
                        logging.warning(
                            f"Segment {key} at {start}-{end} has word "
                            f"`{w[2]}` with non-positive duration. Skipping."
                        )
                        continue
                    word_alignments.append(
                        AlignmentItem(
                            start=w_start, duration=w_dur, symbol=w_symbol
                        )
                    )
                text = (
                    ("" if keep_punctuation else " ")
                    .join(w.symbol for w in word_alignments)
                    .strip()
                )
                annotations[key].append(
                    AmiSegmentAnnotation(
                        text=text,
                        speaker=key[1],
                        gender=key[1][0],
                        start_time=start,
                        end_time=end,
                        words=word_alignments,
                    )
                )
    return annotations


def prepare_audio_grouped(audio_paths: List[Path]) -> RecordingSet:
    """IHM/MDM: group per-channel wavs of one session into a multi-source
    Recording (one channel per source)."""
    by_session = defaultdict(list)
    for p in audio_paths:
        by_session[p.parts[-3]].append(p)

    recordings = []
    for session_name, channel_paths in sorted(by_session.items()):
        probe = Recording.from_file(channel_paths[0])
        sources = []
        all_mono = True
        for idx, audio_path in enumerate(sorted(channel_paths)):
            ch_probe = Recording.from_file(audio_path)
            if ch_probe.num_channels > 1:
                logging.warning(f"Skipping recording {session_name}: stereo channel file.")
                all_mono = False
                break
            sources.append(AudioSource(type="file", channels=[idx], source=str(audio_path)))
        if not all_mono:
            continue
        recordings.append(
            Recording(
                id=session_name,
                sources=sources,
                sampling_rate=probe.sampling_rate,
                num_samples=probe.num_samples,
                duration=probe.duration,
            )
        )
    return RecordingSet.from_recordings(recordings)


def prepare_audio_single(audio_paths: List[Path], mic: Optional[str] = "ihm-mix") -> RecordingSet:
    """IHM-Mix / SDM / mdm8-bf: one file per session."""
    recordings = []
    for audio_path in sorted(audio_paths):
        session_name = (audio_path.parts[-3] if mic != "mdm8-bf" else audio_path.parts[-2])
        recordings.append(Recording.from_file(audio_path, recording_id=session_name))
    return RecordingSet.from_recordings(recordings)


def prepare_supervision_ihm(
    audio: RecordingSet, annotations: Dict[Tuple[str, str, int], List[AmiSegmentAnnotation]],
) -> SupervisionSet:
    by_id_and_channel = {(key[0], key[2]): value for key, value in annotations.items()}
    segments = []
    for recording in audio:
        for source in recording.sources:
            (channel,) = source.channels
            annotation = by_id_and_channel.get((recording.id, channel))
            if annotation is None:
                logging.warning(
                    f"No annotation found for recording {recording.id} "
                    f"(file {source.source})"
                )
                continue
            for seg_idx, seg_info in enumerate(annotation):
                duration = add_durations(
                    seg_info.end_time, -seg_info.start_time, sampling_rate=16000)
                if seg_info.end_time > recording.duration:
                    logging.warning(
                        f"Segment {recording.id}-{channel}-{seg_idx} exceeds "
                        "recording duration. Not adding to supervisions."
                    )
                    continue
                if duration > 0:
                    segments.append(
                        SupervisionSegment(
                            id=f"{recording.id}-{channel}-{seg_idx}",
                            recording_id=recording.id,
                            start=round(seg_info.start_time, ndigits=4),
                            duration=duration,
                            channel=channel,
                            language="English",
                            speaker=seg_info.speaker,
                            gender=seg_info.gender,
                            text=seg_info.text,
                            alignment={"word": seg_info.words},
                        )
                    )
    return SupervisionSet.from_segments(segments)


def prepare_supervision_other(
    audio: RecordingSet, annotations: Dict[Tuple[str, str, int], List[AmiSegmentAnnotation]],
) -> SupervisionSet:
    by_id = defaultdict(list)
    for key, value in annotations.items():
        by_id[key[0]].extend(value)
    segments = []
    for recording in audio:
        annotation = by_id.get(recording.id)
        if annotation is None:
            logging.warning(f"No annotation found for recording {recording.id}")
            continue
        if any(len(source.channels) > 1 for source in recording.sources):
            logging.warning(
                f"More than 1 channels in recording {recording.id}. "
                "Skipping this recording."
            )
            continue
        for seg_idx, seg_info in enumerate(annotation):
            duration = seg_info.end_time - seg_info.start_time
            if duration > 0:
                segments.append(
                    SupervisionSegment(
                        id=f"{recording.id}-{seg_idx}",
                        recording_id=recording.id,
                        start=seg_info.start_time,
                        duration=duration,
                        channel=recording.channel_ids,
                        language="English",
                        speaker=seg_info.speaker,
                        gender=seg_info.gender,
                        text=seg_info.text,
                        alignment={"word": seg_info.words},
                    )
                )
    return SupervisionSet.from_segments(segments)


def prepare_ami(
    data_dir: Pathlike, annotations_dir: Optional[Pathlike] = None,
    output_dir: Optional[Pathlike] = None, mic: Optional[str] = "ihm",
    partition: Optional[str] = "full-corpus", normalize_text: str = "kaldi",
    max_words_per_segment: Optional[int] = None, merge_consecutive: bool = False,
    keep_punctuation: Optional[bool] = False,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Prepare train/dev/test manifests for the chosen mic and official
    partition; supervisions carry word alignments from the manual
    annotations.
    """
    data_dir = Path(data_dir)
    assert data_dir.is_dir(), f"No such directory: {data_dir}"
    assert mic in MICS, f"Mic {mic} not supported"
    assert partition in PARTITIONS, f"Partition {partition} not supported"
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    logging.info("Parsing AMI annotations")
    if not annotations_dir:
        if (data_dir / "ami_public_manual_1.6.2").is_dir():
            annotations_dir = data_dir / "ami_public_manual_1.6.2"
        elif (data_dir / "ami_public_manual_1.6.2.zip").is_file():
            annotations_dir = data_dir / "ami_public_manual_1.6.2.zip"
        else:
            raise ValueError(f"No annotations directory specified and no zip found in {data_dir}")
    annotations = parse_ami_annotations(
        Path(annotations_dir), normalize=normalize_text,
        max_words_per_segment=max_words_per_segment, merge_consecutive=merge_consecutive,
        keep_punctuation=keep_punctuation)

    logging.info("Preparing recording manifests")
    if mic in ("ihm", "mdm"):
        pattern = "*Headset-?.wav" if mic == "ihm" else "*Array?-0?.wav"
        audio = prepare_audio_grouped(list(data_dir.rglob(pattern)))
    else:
        pattern = {
            "ihm-mix": "*Mix-Headset.wav", "sdm": "*Array1-01.wav", "mdm8-bf": "*MDM8.wav"}[mic]
        audio = prepare_audio_single(list(data_dir.rglob(pattern)), mic)

    logging.info("Preparing supervision manifests")
    supervision = (
        prepare_supervision_ihm(audio, annotations)
        if mic == "ihm"
        else prepare_supervision_other(audio, annotations)
    )

    manifests = {}
    dataset_parts = PARTITIONS[partition]
    for part in ("train", "dev", "test"):
        audio_part = audio.filter(lambda x: x.id in dataset_parts[part])
        supervision_part = supervision.filter(lambda x: x.recording_id in dataset_parts[part])
        audio_part, supervision_part = fix_manifests(audio_part, supervision_part)
        validate_recordings_and_supervisions(audio_part, supervision_part)
        if output_dir is not None:
            audio_part.to_file(output_dir / f"ami-{mic}_recordings_{part}.jsonl.gz")
            supervision_part.to_file(output_dir / f"ami-{mic}_supervisions_{part}.jsonl.gz")
        manifests[part] = {"recordings": audio_part, "supervisions": supervision_part}
    return manifests
