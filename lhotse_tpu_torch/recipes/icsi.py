"""
ICSI Meeting Corpus recipe (copied from ``lhotse_tpu/recipes/icsi.py``):
about 72 h of natural meetings recorded at ICSI, with close-talk channels
chan0-chanB, the distant microphones chanE/F/6/7 and a headset mix, and
the NXT annotations' word timings. ``parse_icsi_annotations`` reads the
MRT preambles (the speaker-to-channel maps) and the per-speaker Segments
and Words XML files into word-aligned speaker turns;
``prepare_audio_grouped`` joins a session's per-channel SPHERE files into
one multi-source ``Recording`` (ihm, mdm), ``prepare_audio_single`` takes
one file per session (sdm, ihm-mix), and ``save_to_wav`` decodes each
``.sph`` file once through the SPHERE reader and writes it as WAV.

The downloads (``download_audio``, ``download_icsi``) are not ported: they
need the network.
"""
import logging
import xml.etree.ElementTree as ET
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet
from lhotse_tpu_torch.recipes.ami import normalize_text_ami
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, Seconds, add_durations

# fmt: off
PARTITIONS = {
    "train": [ "Bdb001", "Bed002", "Bed003", "Bed004", "Bed005", "Bed006", "Bed008", "Bed009", "Bed010", "Bed011", "Bed012", "Bed013", "Bed014", "Bed015", "Bed016", "Bed017", "Bmr001", "Bmr002", "Bmr003", "Bmr005", "Bmr006", "Bmr007", "Bmr008", "Bmr009", "Bmr010", "Bmr011", "Bmr012", "Bmr014", "Bmr015", "Bmr016", "Bmr019", "Bmr020", "Bmr022", "Bmr023", "Bmr024", "Bmr025", "Bmr026", "Bmr027", "Bmr028", "Bmr029", "Bmr030", "Bmr031", "Bns002", "Bns003", "Bro003", "Bro004", "Bro005", "Bro007", "Bro008", "Bro010", "Bro011", "Bro012", "Bro013", "Bro014", "Bro015", "Bro016", "Bro017", "Bro018", "Bro019", "Bro022", "Bro023", "Bro024", "Bro025", "Bro026", "Bro027", "Bro028", "Bsr001", "Btr001", "Btr002", "Buw001", ],
    "dev": ["Bmr021", "Bns001"], "test": ["Bmr013", "Bmr018", "Bro021"]}
# fmt: on

MIC_TO_CHANNELS = {
    "ihm": list("0123456789AB"), "sdm": ["6"], "mdm": ["E", "F", "6", "7"], "ihm-mix": []}


class IcsiSegmentAnnotation(NamedTuple):
    text: str
    speaker: str
    gender: str
    start_time: Seconds
    end_time: Seconds
    words: List[AlignmentItem]


def parse_icsi_annotations(
    transcripts_dir: Pathlike, normalize: str = "upper",
) -> Tuple[Dict[Tuple[str, str, str], List[IcsiSegmentAnnotation]], Dict[str, Dict[str, int]]]:
    """Returns (annotations keyed by (meeting, speaker, channel-name),
    per-meeting channel-name -> integer index map)."""
    transcripts_dir = Path(transcripts_dir)

    channel_to_idx_map: Dict[str, Dict[str, int]] = defaultdict(dict)
    spk_to_channel_map: Dict[str, Dict[str, str]] = defaultdict(dict)
    root = ET.parse(transcripts_dir / "preambles.mrt").getroot()
    for meeting in root:
        if meeting.tag != "Meeting":
            continue
        meeting_id = meeting.attrib["Session"]
        for preamble in meeting:
            if preamble.tag != "Preamble":
                continue
            for section in preamble:
                if section.tag == "Channels":
                    channel_to_idx_map[meeting_id] = {
                        channel.attrib["Name"]: idx for idx, channel in enumerate(section)}
                elif section.tag == "Participants":
                    for speaker in section:
                        # Speakers without a channel get the SDM channel.
                        spk_to_channel_map[meeting_id][
                            speaker.attrib["Name"]
                        ] = speaker.attrib.get("Channel", "chan6")

    # Speaker turn intervals per (meeting, local agent).
    segments = {}
    for file in sorted((transcripts_dir / "Segments").glob("*.xml")):
        meet_id, local_id, _ = file.stem.split(".")
        spk_id = None
        spk_segments = []
        for seg in ET.parse(file).getroot():
            if seg.tag != "segment":
                continue
            if spk_id is None and "participant" in seg.attrib:
                spk_id = seg.attrib["participant"]
            spk_segments.append((float(seg.attrib["starttime"]), float(seg.attrib["endtime"])))
        if spk_id is None or not spk_segments:
            continue
        channel = spk_to_channel_map[meet_id][spk_id]
        segments[(meet_id, local_id)] = (spk_id, channel, spk_segments)

    # Word timings per (meeting, local agent).
    words = {}
    for file in sorted((transcripts_dir / "Words").glob("*.xml")):
        key = tuple(file.stem.split(".")[:2])
        if key not in segments:
            continue
        entries = []
        for word in ET.parse(file).getroot():
            if (
                word.tag != "w"
                or not word.attrib.get("starttime")
                or not word.attrib.get("endtime")
            ):
                continue
            entries.append(
                (
                    float(word.attrib["starttime"]),
                    float(word.attrib["endtime"]),
                    word.text,
                )
            )
        words[key] = entries

    annotations = defaultdict(list)
    for key, (spk_id, channel, spk_segments) in segments.items():
        spk_words = words.get(key, [])
        new_key = (key[0], spk_id, channel)
        for seg_start, seg_end in spk_segments:
            seg_words = [w for w in spk_words if w[0] >= seg_start and w[1] <= seg_end]
            if not seg_words:
                continue
            start, end = seg_words[0][0], seg_words[-1][1]
            word_alignments = []
            for w in seg_words:
                w_start = max(start, round(w[0], ndigits=4))
                w_end = min(end, round(w[1], ndigits=4))
                w_dur = add_durations(w_end, -w_start, sampling_rate=16000)
                w_symbol = normalize_text_ami(w[2], normalize=normalize)
                if not w_symbol:
                    continue
                if w_dur <= 0:
                    logging.warning(
                        f"Segment {key[0]}.{spk_id}.{channel} at {start}-{end} "
                        f"has a non-positive-duration word. Skipping."
                    )
                    continue
                word_alignments.append(
                    AlignmentItem(start=w_start, duration=w_dur, symbol=w_symbol)
                )
            annotations[new_key].append(
                IcsiSegmentAnnotation(
                    text=" ".join(w.symbol for w in word_alignments),
                    speaker=spk_id,
                    gender=spk_id[0],
                    start_time=start,
                    end_time=end,
                    words=word_alignments,
                )
            )
    return annotations, channel_to_idx_map


def _sph_to_wav(sph_path: Path, output_dir: Pathlike) -> Path:
    """Decode one .sph channel file and persist it as WAV under
    ``output_dir/wavs/<session>/``; returns the new path so the Recording
    points at the faster-to-read copy."""
    from lhotse_tpu_torch.audio.wavio import write_wav

    session_dir = Path(output_dir) / "wavs" / sph_path.parts[-2]
    session_dir.mkdir(parents=True, exist_ok=True)
    wav_path = session_dir / f"{sph_path.stem}.wav"
    rec = Recording.from_file(sph_path)
    write_wav(wav_path, rec.load_audio(), rec.sampling_rate)
    return wav_path


def prepare_audio_grouped(
    audio_paths: List[Path], channel_to_idx_map: Optional[Dict[str, Dict[str, int]]] = None,
    save_to_wav: bool = False, output_dir: Optional[Pathlike] = None,
) -> RecordingSet:
    """ihm/mdm: group a session's per-channel files into one Recording,
    with channel indices from the preambles map."""
    by_session = defaultdict(list)
    for p in audio_paths:
        by_session[p.parts[-2]].append(p)
    if channel_to_idx_map is None:
        channel_to_idx_map = defaultdict(dict)

    recordings = []
    for session_name, channel_paths in sorted(by_session.items()):
        if save_to_wav:
            channel_paths = [_sph_to_wav(p, output_dir) for p in channel_paths]
        if session_name not in channel_to_idx_map:
            channel_to_idx_map[session_name] = {
                c: idx for idx, c in enumerate(["chanE", "chanF", "chan6", "chan7"])}
        probe = Recording.from_file(channel_paths[0])
        recordings.append(
            Recording(
                id=session_name,
                sources=[
                    AudioSource(
                        type="file",
                        channels=[channel_to_idx_map[session_name][p.stem]],
                        source=str(p),
                    )
                    for p in sorted(channel_paths)
                    if p.stem in channel_to_idx_map[session_name]
                ],
                sampling_rate=probe.sampling_rate,
                num_samples=probe.num_samples,
                duration=probe.duration,
            )
        )
    return RecordingSet.from_recordings(recordings)


def prepare_audio_single(
    audio_paths: List[Path], save_to_wav: bool = False,
    output_dir: Optional[Pathlike] = None) -> RecordingSet:
    """sdm/ihm-mix: one file per session."""
    if save_to_wav:
        audio_paths = [
            _sph_to_wav(p, output_dir) if p.suffix == ".sph" else p for p in audio_paths
        ]
    return RecordingSet.from_recordings(
        Recording.from_file(p, recording_id=p.parts[-2]) for p in sorted(audio_paths)
    )


def prepare_supervision_ihm(
    audio: RecordingSet, annotations: Dict[Tuple[str, str, str], List[IcsiSegmentAnnotation]],
    channel_to_idx_map: Dict[str, Dict[str, int]]) -> SupervisionSet:
    by_id_and_channel = {
        (key[0], channel_to_idx_map[key[0]][key[2]]): value for key,
        value in annotations.items() if key[2] in channel_to_idx_map[key[0]]}
    segments = []
    for recording in audio:
        for source in recording.sources:
            (channel,) = source.channels
            annotation = by_id_and_channel.get((recording.id, channel))
            if annotation is None:
                continue
            for seg_idx, seg_info in enumerate(annotation):
                duration = seg_info.end_time - seg_info.start_time
                if seg_info.end_time > recording.duration:
                    logging.warning(
                        f"Segment {recording.id}-{channel}-{seg_idx} exceeds "
                        f"recording duration. Not adding to supervisions."
                    )
                    continue
                if duration > 0:
                    segments.append(
                        SupervisionSegment(
                            id=f"{recording.id}-{channel}-{seg_idx}",
                            recording_id=recording.id,
                            start=seg_info.start_time,
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
    audio: RecordingSet, annotations: Dict[Tuple[str, str, str], List[IcsiSegmentAnnotation]],
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
        if len(recording.sources[0].channels) > 1:
            logging.warning(f"More than 1 channels in recording {recording.id}. Skipping.")
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


def prepare_icsi(
    audio_dir: Pathlike, transcripts_dir: Optional[Pathlike] = None,
    output_dir: Optional[Pathlike] = None, mic: Optional[str] = "ihm",
    normalize_text: str = "kaldi",
    save_to_wav: bool = False) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Prepare train/dev/test manifests for the chosen mic variant.

    :param save_to_wav: decode the .sph channel files once and store them as
        WAV under ``output_dir/wavs`` (manifests then reference the WAVs,
        which are much faster to read during training).
    """
    audio_dir = Path(audio_dir)
    if save_to_wav:
        assert output_dir is not None, "`save_to_wav=True` requires `output_dir`."
    transcripts_dir = (
        Path(transcripts_dir)
        if transcripts_dir is not None
        else audio_dir / "transcripts"
    )
    assert audio_dir.is_dir(), f"No such directory: {audio_dir}"
    assert transcripts_dir.is_dir(), f"No such directory: {transcripts_dir}"
    assert mic in MIC_TO_CHANNELS, f"Mic {mic} not supported"
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)

    logging.info("Parsing ICSI transcripts")
    annotations, channel_to_idx_map = parse_icsi_annotations(
        transcripts_dir, normalize=normalize_text)

    logging.info("Preparing recording manifests")
    channels = "".join(MIC_TO_CHANNELS[mic])
    if mic in ("ihm", "mdm"):
        audio = prepare_audio_grouped(
            list(audio_dir.rglob(f"chan[{channels}].sph")),
            channel_to_idx_map if mic == "ihm" else None,
            save_to_wav=save_to_wav, output_dir=output_dir)
    else:
        audio_paths = (
            audio_dir.rglob(f"chan[{channels}].sph")
            if channels
            else audio_dir.rglob("*.wav")
        )
        audio = prepare_audio_single(
            list(audio_paths), save_to_wav=save_to_wav, output_dir=output_dir)

    logging.info("Preparing supervision manifests")
    supervision = (
        prepare_supervision_ihm(audio, annotations, channel_to_idx_map)
        if mic == "ihm"
        else prepare_supervision_other(audio, annotations)
    )

    manifests = {}
    for part in ("train", "dev", "test"):
        audio_part = audio.filter(lambda x: x.id in PARTITIONS[part])
        supervision_part = supervision.filter(lambda x: x.recording_id in PARTITIONS[part])
        audio_part, supervision_part = fix_manifests(audio_part, supervision_part)
        validate_recordings_and_supervisions(audio_part, supervision_part)
        if output_dir is not None:
            audio_part.to_file(output_dir / f"icsi-{mic}_recordings_{part}.jsonl.gz")
            supervision_part.to_file(output_dir / f"icsi-{mic}_supervisions_{part}.jsonl.gz")
        manifests[part] = {"recordings": audio_part, "supervisions": supervision_part}
    return manifests
