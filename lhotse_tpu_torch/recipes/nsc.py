"""
National Speech Corpus recipe (copied from ``lhotse_tpu/recipes/nsc.py``):
Singapore English from IMDA in six parts, read speech (parts 1-2, three mic
channels each), conversations (part 3), code-switching (part 4), styled
speech (part 5) and call-centre simulations (part 6). Parts 1-2 are zipped
per speaker, with one tab-separated script per session that alternates an
id row and a text row; parts 3-6 pair each audio file with a TextGrid
(``PART3_SeparateIVR`` prefixes the session directory to its name), skip
the ``<S>`` and ``<Z>`` silence marks and clip segments to the recording.
TextGrids are read by ``recipes/textgrid.py``, trying utf-8, utf-16 and
latin-1 in turn; a binary TextGrid is refused.
"""
import itertools
import logging
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.textgrid import Tier, parse_textgrid
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

logger = logging.getLogger(__name__)

NSC_PARTS = [
    "PART1_CHANNEL0", "PART1_CHANNEL1", "PART1_CHANNEL2",
    "PART2_CHANNEL0", "PART2_CHANNEL1", "PART2_CHANNEL2",
    "PART3_SameBoundaryMic", "PART3_SameCloseMic", "PART3_SeparateIVR",
    "PART3_SeparateStandingMic",
    "PART4_CodeswitchingDiffRoom", "PART4_CodeswitchingSameRoom",
    "PART5_Debate", "PART5_FinanceEmotion",
    "PART6_CallCentreDesign1", "PART6_CallCentreDesign2", "PART6_CallCentreDesign3"]

_SILENCE_MARKS = ("<S>", "<Z>")


@dataclass
class ScriptAudioDir:
    script_dir: Union[str, Path]
    audio_dir: Union[str, Path]

    def relative_to(self, parent: Union[str, Path]) -> "ScriptAudioDir":
        parent = Path(parent)
        return ScriptAudioDir(
            script_dir=parent / self.script_dir, audio_dir=parent / self.audio_dir)


@dataclass
class HandlerMapping:
    handler: Callable
    script_audio: ScriptAudioDir


def get_part_handler_map(corpus_dir: Path) -> Dict[str, HandlerMapping]:
    """The published directory layout of each NSC part."""
    p13 = corpus_dir / "IMDA - National Speech Corpus"
    p46 = (corpus_dir / "IMDA - National Speech Corpus - Additional"
           / "IMDA - National Speech Corpus (Additional)")

    def read_part(channel_dir: str) -> HandlerMapping:
        return HandlerMapping(
            handler=prepare_part1,
            script_audio=ScriptAudioDir(
                script_dir=f"{channel_dir}/SCRIPT",
                audio_dir=f"{channel_dir}/WAVE").relative_to(p13))

    def tg_part(handler, script_dir: str, audio_dir: str, parent: Path) -> HandlerMapping:
        return HandlerMapping(
            handler=handler,
            script_audio=ScriptAudioDir(
                script_dir=script_dir, audio_dir=audio_dir).relative_to(parent))

    mapping = {}
    for part, chan in itertools.product(("PART1", "PART2"), range(3)):
        mapping[f"{part}_CHANNEL{chan}"] = read_part(f"{part}/DATA/CHANNEL{chan}")
    mapping.update({
        "PART3_SameBoundaryMic": tg_part(
            prepare_part3, "PART3/Scripts Same", "PART3/Audio Same BoundaryMic", p13),
        "PART3_SameCloseMic": tg_part(
            prepare_part3, "PART3/Scripts Same", "PART3/Audio Same CloseMic", p13),
        "PART3_SeparateIVR": tg_part(
            prepare_part3, "PART3/Scripts Separate", "PART3/Audio Separate IVR", p13),
        "PART3_SeparateStandingMic": tg_part(
            prepare_part3, "PART3/Scripts Separate", "PART3/Audio Separate StandingMic",
            p13),
        "PART4_CodeswitchingDiffRoom": tg_part(
            prepare_part4, "PART4/Codeswitching/Diff Room Scripts",
            "PART4/Codeswitching/Diff Room Audio", p46),
        "PART4_CodeswitchingSameRoom": tg_part(
            prepare_part4, "PART4/Codeswitching/Same Room Scripts",
            "PART4/Codeswitching/Same Room Audio", p46),
        "PART5_Debate": tg_part(
            prepare_part5, "PART5/Debate Scripts", "PART5/Debate Audio", p46),
        "PART5_FinanceEmotion": tg_part(
            prepare_part5, "PART5/Finance + Emotion Scripts",
            "PART5/Finance + Emotions Audio", p46),
        "PART6_CallCentreDesign1": tg_part(
            prepare_part6, "PART6/Call Centre Design 1/Scripts",
            "PART6/Call Centre Design 1/Audio", p46),
        "PART6_CallCentreDesign2": tg_part(
            prepare_part6, "PART6/Call Centre Design 2/Scripts",
            "PART6/Call Centre Design 2/Audio", p46),
        "PART6_CallCentreDesign3": tg_part(
            prepare_part6, "PART6/Call Centre Design 3/Scripts",
            "PART6/Call Centre Design 3/Audio", p46)})
    return mapping


def _read_textgrid_tiers(script_file: Path) -> List[Tier]:
    """Read a TextGrid trying a few encodings; binary files are rejected."""
    raw = Path(script_file).read_bytes()
    if raw.startswith(b"ooBinaryFile\x08TextGrid"):
        raise ValueError(f"Binary TextGrid is not supported: {script_file}")
    for encoding in ("utf-8-sig", "utf-16", "latin-1"):
        try:
            return parse_textgrid(raw.decode(encoding))
        except (UnicodeDecodeError, UnicodeError):
            continue
    raise ValueError(f"Could not decode TextGrid: {script_file}")


def _tier_by_key(tiers: List[Tier], key: Optional[str]) -> Tier:
    if key is None:
        return tiers[0]
    for tier in tiers:
        if tier.name == key:
            return tier
    raise KeyError(f"No TextGrid tier named {key!r}")


def prepare_nsc(
    corpus_dir: Pathlike, dataset_part: str = "PART3_SameCloseMic",
    output_dir: Optional[Pathlike] = None, num_jobs: int = 1,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Manifests for one NSC part. The returned dict is the one the part's
    handler made; the files written to ``output_dir`` hold the manifests
    after ``fix_manifests``."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    part_handler_map = get_part_handler_map(corpus_dir)
    if dataset_part not in part_handler_map:
        raise ValueError(f"Unknown dataset part: {dataset_part}")
    handler_map = part_handler_map[dataset_part]
    manifests = handler_map.handler(dataset_part, handler_map.script_audio, num_jobs)
    recordings, supervisions = fix_manifests(**manifests)
    validate_recordings_and_supervisions(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        supervisions.to_file(output_dir / f"nsc_supervisions_{dataset_part}.jsonl.gz")
        recordings.to_file(output_dir / f"nsc_recordings_{dataset_part}.jsonl.gz")
    return manifests


# --- parts 1-2: per-speaker zipped read sessions ------------------------------
def prepare_part1(part_name: str, script_audio_dir: ScriptAudioDir, num_jobs: int = 1):
    recordings, supervisions = [], []
    audio_dir = Path(script_audio_dir.audio_dir)
    script_dir = Path(script_audio_dir.script_dir)
    channel = int(part_name[-1:])  # e.g. PART1_CHANNEL0
    assert channel in {0, 1, 2}
    extract_to_dir = audio_dir / "extracted"
    extract_to_dir.mkdir(exist_ok=True)
    for speaker_zip in sorted(audio_dir.glob("SPEAKER*.zip")):
        speaker_manifests = _parse_part1_speaker(
            speaker_zip, script_dir, channel, extract_to_dir)
        recordings.extend(speaker_manifests["recordings"])
        supervisions.extend(speaker_manifests["supervisions"])
    return {
        "recordings": RecordingSet.from_recordings(recordings),
        "supervisions": SupervisionSet.from_segments(supervisions)}


def prepare_part2(part_name: str, script_audio_dir: ScriptAudioDir, num_jobs: int = 1):
    """Part 2 shares part 1's zipped read-session layout."""
    return prepare_part1(part_name, script_audio_dir, num_jobs)


def _parse_part1_speaker(
    speaker_zip_file: Path, script_dir: Path, channel: int,
    extract_to_dir: Optional[Path] = None):
    recordings, supervisions = [], []
    mapping = _preprocess_part1_speaker(
        speaker_zip_file, script_dir, channel, extract_to_dir)
    for script_file, session_dir in mapping.items():
        recs, sups = _parse_part1_script(script_file, session_dir)
        recordings.extend(recs)
        supervisions.extend(sups)
    return {"recordings": recordings, "supervisions": supervisions}


def _preprocess_part1_speaker(
    speaker_zip_file: Path, script_dir: Path, channel: int,
    extract_to_dir: Optional[Path] = None) -> Dict[Path, Path]:
    """Unzip one speaker; map each session's script file to its audio dir."""
    if extract_to_dir is None:
        extract_to_dir = speaker_zip_file.parent
    speaker_audio_dir = extract_to_dir / speaker_zip_file.stem
    if not speaker_audio_dir.exists():
        with zipfile.ZipFile(speaker_zip_file) as zf:
            zf.extractall(extract_to_dir)
    else:
        logger.warning(
            f'Reusing "{speaker_audio_dir}" as extracted "{speaker_zip_file}" '
            f"since it exists already")
    spk_id = speaker_audio_dir.stem.removeprefix("SPEAKER")
    return {
        script_dir / f"{channel}{spk_id}{session_dir.stem.removeprefix('SESSION')}.TXT":
            session_dir
        for session_dir in sorted(speaker_audio_dir.glob("SESSION*"))}


def _parse_part1_script(script_file: Path, session_dir: Path):
    """Scripts pair an id row with a text row; flush on id change."""
    recordings, supervisions = [], []

    def flush(audio_id: str, text: str):
        recording, segment = _create_part1_single_record(session_dir, audio_id, text)
        if recording:
            recordings.append(recording)
            supervisions.append(segment)

    previous_audio_id = ""
    previous_text = ""
    with open(script_file, encoding="utf-8-sig") as f:
        for line in f:
            columns = line.rstrip("\n").split("\t")
            if previous_audio_id and columns[0] != previous_audio_id:
                if columns[0] == "":
                    previous_text = columns[1]
                flush(previous_audio_id, previous_text)
                previous_audio_id = previous_text = ""
            else:
                previous_audio_id = columns[0]
                previous_text = columns[1]
    if previous_audio_id:
        flush(previous_audio_id, previous_text)
    return recordings, supervisions


def _create_part1_single_record(
    session_dir: Path, audio_id: str, text: str,
) -> Tuple[Optional[Recording], Optional[SupervisionSegment]]:
    audio_file = session_dir / f"{audio_id}.WAV"
    try:
        recording = Recording.from_file(audio_file, recording_id=audio_id)
        segment = SupervisionSegment(
            id=recording.id, recording_id=recording.id, start=0,
            duration=recording.duration, text=text)
        return recording, segment
    except FileNotFoundError:
        logger.warning(
            f'Recording audio of script "{audio_id}" can not be found in "{session_dir}"')
    except Exception as e:
        logger.error(f"Error occurred with {audio_file}: {e}")
    return None, None


# --- parts 3-6: TextGrid-scripted conversations -------------------------------
def prepare_part3(part_name: str, script_audio_dir: ScriptAudioDir, num_jobs: int = 1):
    assert part_name != "PART3_SameBoundaryMic", (
        "The recipe too different, currently not supported")

    def resolve(audio_file: Path) -> Tuple[List[Tier], Optional[str]]:
        script_dir = Path(script_audio_dir.script_dir)
        if part_name == "PART3_SeparateIVR":
            stem = audio_file.parent.name + "_" + audio_file.stem
        else:
            stem = audio_file.stem
        return _read_textgrid_tiers(script_dir / f"{stem}.TextGrid"), stem

    return prepare_textgrid_based_part(part_name, script_audio_dir, resolve, num_jobs)


def prepare_part4(part_name: str, script_audio_dir: ScriptAudioDir, num_jobs: int = 1):
    def resolve(audio_file: Path) -> Tuple[List[Tier], Optional[str]]:
        script_dir = Path(script_audio_dir.script_dir)
        tiers = _read_textgrid_tiers(script_dir / f"{audio_file.stem}.TextGrid")
        return tiers, None  # first tier

    return prepare_textgrid_based_part(part_name, script_audio_dir, resolve, num_jobs)


def prepare_part5(part_name: str, script_audio_dir: ScriptAudioDir, num_jobs: int = 1):
    """Part 5 resolves TextGrids by first tier exactly like part 4."""
    return prepare_part4(part_name, script_audio_dir, num_jobs)


def prepare_part6(part_name: str, script_audio_dir: ScriptAudioDir, num_jobs: int = 1):
    """Part 6 delegates to part 5."""
    return prepare_part5(part_name, script_audio_dir, num_jobs)


def prepare_textgrid_based_part(
    part_name: str, script_audio_dir: ScriptAudioDir,
    textgrid_loader: Callable, num_jobs: int = 1):
    recordings, supervisions = [], []
    audio_dir = Path(script_audio_dir.audio_dir)
    audio_files = sorted(
        itertools.chain(audio_dir.rglob("**/*.wav"), audio_dir.rglob("**/*.WAV")))
    processed = set()
    for audio_path in audio_files:
        try:
            recording_id = f"{part_name}_{audio_path.stem}"
            assert recording_id not in processed, (
                f'Duplicated recording id "{recording_id}", audio path: "{audio_path}"')
            processed.add(recording_id)
            recording = Recording.from_file(audio_path, recording_id=recording_id)
            tiers, key = textgrid_loader(audio_path)
            tier = _tier_by_key(tiers, key)
            segments = [
                s for s in (
                    SupervisionSegment(
                        id=f"{recording.id}-{idx}", recording_id=recording.id,
                        start=segment.minTime,
                        duration=min(
                            round(segment.maxTime - segment.minTime, ndigits=8),
                            recording.duration - segment.minTime),
                        text=segment.mark, language="Singaporean English",
                        speaker=recording_id)
                    for idx, segment in enumerate(tier.intervals)
                    if segment.mark not in _SILENCE_MARKS)
                if s.duration > 0]  # NSC has some bad segments
            supervisions.extend(segments)
            recordings.append(recording)
        except Exception as e:
            logger.warning(f'Error when processing "{audio_path}" - skipping... ({e})')
    return {
        "recordings": RecordingSet.from_recordings(recordings),
        "supervisions": SupervisionSet.from_segments(supervisions)}
