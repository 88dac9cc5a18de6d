"""
Bridging to Kaldi data directories (wav.scp / segments / text / utt2spk ...),
copied from ``lhotse_tpu/kaldi.py``.

Import (:func:`load_kaldi_data_dir`) turns a Kaldi data dir into
(RecordingSet, SupervisionSet?, FeatureSet?); export (:func:`export_to_kaldi`)
writes a compatible manifest pair back out.  Multi-channel recordings are
flattened to one Kaldi entry per channel on export, so that direction is not
losslessly round-trippable. A ``wav.scp`` line that ends in ``|`` becomes a
``command`` audio source, whose pipe runs at every read (see
:mod:`lhotse_tpu_torch.audio.source`).

The JAX package's behaviour is kept as it is, asymmetries included: export
writes ``utt2gender`` where import reads ``spk2gender``; a ``command``
source keeps the space before the ``|``; the duration of a pipe without
``reco2dur``, and ``feats.scp``, need the ``kaldi_native_io`` package (with
it missing, the first raises ``ValueError`` and the second yields no
``FeatureSet``).
"""
import logging
import math
import warnings
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet, info
from lhotse_tpu_torch.features import Features, FeatureSet
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import (
    Pathlike, Seconds, add_durations, compute_num_samples, fastcopy, is_module_available, to_list)


def floor_duration_to_milliseconds(duration: float) -> float:
    """
    Truncate to whole milliseconds.  Kaldi tools and this library round
    differently at the microsecond level; flooring keeps supervision ends
    from poking past cut ends while staying inside the 2 ms ASR tolerance.
    """
    return math.floor(1000 * duration) / 1000


def get_duration(path: Pathlike) -> Optional[float]:
    """
    Duration of an audio file, or of a Kaldi "pipe" command (trailing ``|``).
    Returns None when the audio cannot be read, letting callers drop it.
    """
    path = str(path)
    if path.strip().endswith("|"):
        if not is_module_available("kaldi_native_io"):
            raise ValueError(
                "To read Kaldi's data dir where wav.scp has 'pipe' inputs, "
                "please 'pip install kaldi_native_io' first."
            )
        import kaldi_native_io

        try:
            wave = kaldi_native_io.read_wave(path)
            if wave.data.shape[0] != 1:
                raise AssertionError(f"Expect 1 channel. Given {wave.data.shape[0]}")
            return floor_duration_to_milliseconds(wave.duration)
        except Exception:
            return None
    try:
        return floor_duration_to_milliseconds(info(path).duration)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Import
# ---------------------------------------------------------------------------
def load_kaldi_data_dir(
    path: Pathlike, sampling_rate: int, frame_shift: Optional[Seconds] = None,
    map_string_to_underscores: Optional[str] = None, use_reco2dur: bool = True, num_jobs: int = 1,
    feature_type: str = "kaldi-fbank",
) -> Tuple[RecordingSet, Optional[SupervisionSet], Optional[FeatureSet]]:
    """
    Read a Kaldi data dir.  ``wav.scp`` is mandatory; ``segments`` (or, for
    whole-recording supervision, ``utt2spk``) and ``feats.scp`` (needs
    kaldi_native_io and ``frame_shift``) are optional.
    """
    path = Path(path)
    if not path.is_dir():
        raise AssertionError(f"Not a directory: {path}")

    def fix_id(t: Optional[str]) -> Optional[str]:
        if map_string_to_underscores is None or t is None:
            return t
        return t.replace(map_string_to_underscores, "_")

    wavs = load_kaldi_text_mapping(path / "wav.scp", must_exist=True)
    durations = _gather_durations(path, wavs, use_reco2dur, num_jobs)

    dropped = [rid for rid, d in durations.items() if d is None]
    for rid in dropped:
        logging.warning(
            f"[{rid}] Could not get duration. Failed to read audio from "
            f"`{wavs[rid]}`. Dropping the recording from manifest."
        )
        del wavs[rid]
    if len(wavs) < len(durations) * 0.8:
        raise RuntimeError(f'Failed to load more than 20% utterances of the dataset: "{path}"')

    recording_set = RecordingSet.from_recordings(
        _recording_from_scp_entry(rid, entry, durations[rid], sampling_rate) for rid,
        entry in wavs.items())

    timing_from_feats = load_start_and_duration(
        segments_path=path / "segments", feats_path=path / "feats.scp", frame_shift=frame_shift)

    supervision_set = None
    if (path / "segments").is_file():
        supervision_set = _supervisions_from_segments(
            path, durations, timing_from_feats, sampling_rate, fix_id)
    elif (path / "utt2spk").is_file():
        supervision_set = _whole_recording_supervisions(path, durations, len(recording_set), fix_id)

    feature_set = _features_from_scp(
        path, supervision_set, timing_from_feats, frame_shift, sampling_rate, feature_type, fix_id)
    return recording_set, supervision_set, feature_set


def _gather_durations(
    path: Path, wavs: Dict[str, str], use_reco2dur: bool, num_jobs: int,
) -> Dict[str, Optional[float]]:
    reco2dur = path / "reco2dur"
    if use_reco2dur and reco2dur.is_file():
        durations = load_kaldi_text_mapping(reco2dur, float_vals=True)
        if len(durations) != len(wavs):
            raise AssertionError(
                "The duration file reco2dur does not have the same length as "
                "the wav.scp file"
            )
        return durations
    if num_jobs == 1:
        values = [get_duration(entry) for entry in wavs.values()]
    else:
        # Hand each child a big slice: per-item task dispatch dominates
        # runtime (and can wedge the executor) on million-file datasets.
        per_chunk = max(1, len(wavs) // (num_jobs * 10))
        with ProcessPoolExecutor(max_workers=num_jobs) as pool:
            values = list(pool.map(get_duration, wavs.values(), chunksize=per_chunk))
    return dict(zip(wavs.keys(), values))


def _recording_from_scp_entry(
    rid: str, entry: str, duration: float, sampling_rate: int) -> Recording:
    is_pipe = entry.endswith("|")
    return Recording(
        id=rid,
        sources=[ AudioSource( type="command" if is_pipe else "file", channels=[0], source=entry[:-1] if is_pipe else entry, ) ],
        sampling_rate=sampling_rate, num_samples=compute_num_samples(duration, sampling_rate),
        duration=duration)


def _supervisions_from_segments(
    path: Path, durations, timing_from_feats, sampling_rate, fix_id) -> SupervisionSet:
    texts = load_kaldi_text_file(path / "text", allow_empty_ref=True)
    speakers = load_kaldi_text_mapping(path / "utt2spk")
    genders = load_kaldi_text_mapping(path / "spk2gender")
    languages = load_kaldi_text_mapping(path / "utt2lang")

    segs = []
    for line in (path / "segments").read_text().splitlines():
        if not line.strip():
            continue
        utt_id, rec_id, start, end = line.split()
        if timing_from_feats:
            # Trust the feature matrix length over the segments file.
            _, duration = timing_from_feats[utt_id]
        else:
            # end == -1 is Kaldi for "runs to the end of the recording".
            until = durations[rec_id] if end == "-1" else float(end)
            duration = add_durations(until, -float(start), sampling_rate=sampling_rate)
        segs.append(
            SupervisionSegment(
                id=fix_id(utt_id),
                recording_id=rec_id,
                start=float(start),
                duration=duration,
                channel=0,
                text=texts.get(utt_id),
                language=languages[utt_id],
                speaker=fix_id(speakers[utt_id]),
                gender=genders[speakers[utt_id]],
            )
        )
    return SupervisionSet.from_segments(segs)


def _whole_recording_supervisions(
    path: Path, durations, num_recordings: int, fix_id) -> SupervisionSet:
    speakers = load_kaldi_text_mapping(path / "utt2spk")
    if len(speakers) != num_recordings:
        raise AssertionError(
            f"utt2spk lists {len(speakers)} utterances but wav.scp yielded "
            f"{num_recordings} recordings."
        )
    texts = load_kaldi_text_mapping(path / "text")
    genders = load_kaldi_text_mapping(path / "spk2gender")
    languages = load_kaldi_text_mapping(path / "utt2lang")
    return SupervisionSet.from_segments(
        SupervisionSegment( id=fix_id(rid), recording_id=rid, start=0.0, duration=durations[rid], channel=0, text=texts[rid], language=languages[rid], speaker=fix_id(spk), gender=genders[spk], ) for rid,
        spk in speakers.items())


def _features_from_scp(
    path, supervision_set, timing_from_feats, frame_shift, sampling_rate, feature_type, fix_id,
) -> Optional[FeatureSet]:
    feats_scp = path / "feats.scp"
    if not (feats_scp.exists() and is_module_available("kaldi_native_io")):
        return None
    if frame_shift is None:
        warnings.warn(
            "Failed to import Kaldi 'feats.scp': frame_shift must be not "
            "None. Feature import omitted."
        )
        return None
    import kaldi_native_io

    feats = []
    for line in feats_scp.read_text().splitlines():
        if not line.strip():
            continue
        utt_id, ark = line.split(maxsplit=1)
        shape = kaldi_native_io.MatrixShape.read(ark)
        if timing_from_feats:
            start, duration = timing_from_feats[utt_id]
        else:
            start, duration = 0, shape.num_rows * frame_shift
        if supervision_set is not None:
            rec_id = supervision_set[fix_id(utt_id)].recording_id
        else:
            rec_id = utt_id
        feats.append(
            Features(
                type=feature_type,
                num_frames=shape.num_rows,
                num_features=shape.num_cols,
                frame_shift=frame_shift,
                sampling_rate=sampling_rate,
                start=start,
                duration=duration,
                storage_type="kaldiio",  # the JAX package's KaldiReader, not ported
                storage_path=ark,
                storage_key=utt_id,
                recording_id=rec_id,
                channels=0,
            )
        )
    return FeatureSet.from_features(feats)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------
def export_to_kaldi(
    recordings: RecordingSet, supervisions: SupervisionSet, output_dir: Pathlike,
    map_underscores_to: Optional[str] = None, prefix_spk_id: Optional[bool] = False):
    """
    Write a Kaldi data directory for a (RecordingSet, SupervisionSet) pair.

    Single-channel corpora keep their ids verbatim (round-trippable);
    anything multi-channel is expanded into per-channel wav.scp entries named
    ``<recording>_<channel>`` with utterances named ``<utt>-<channel>``.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    if map_underscores_to is not None:
        supervisions = supervisions.map(
            lambda s: fastcopy(
                s,
                id=s.id.replace("_", map_underscores_to),
                speaker=s.speaker.replace("_", map_underscores_to),
            )
        )
    if prefix_spk_id:
        supervisions = supervisions.map(lambda s: fastcopy(s, id=f"{s.speaker}-{s.id}"))

    mono = all(r.num_channels == 1 for r in recordings)

    # wav.scp + reco2dur, keyed per recording (mono) or per channel.
    wavscp: Dict[str, str] = {}
    reco2dur: Dict[str, Any] = {}
    for rec in recordings:
        for src in rec.sources:
            by_channel = make_wavscp_channel_string_map(
                src, sampling_rate=rec.sampling_rate, transforms=rec.transforms)
            if mono:
                wavscp[rec.id] = by_channel[0]
                reco2dur[rec.id] = rec.duration
            else:
                for ch in src.channels:
                    wavscp[f"{rec.id}_{ch}"] = by_channel[ch]
                    reco2dur[f"{rec.id}_{ch}"] = rec.duration
    save_kaldi_text_mapping(wavscp, output_dir / "wav.scp")
    save_kaldi_text_mapping(reco2dur, output_dir / "reco2dur")

    # Per-utterance files, all driven by one (utt_key, segment-field) walk.
    def utterance_rows(value_of):
        rows = {}
        for sup in supervisions:
            if mono:
                rows[sup.id] = value_of(sup, None)
            else:
                for ch in to_list(sup.channel):
                    rows[f"{sup.id}-{ch}"] = value_of(sup, ch)
        return rows

    def segment_line(sup, ch):
        rec_key = sup.recording_id if ch is None else f"{sup.recording_id}_{ch}"
        return f"{rec_key} {sup.start} {sup.end}"

    save_kaldi_text_mapping(utterance_rows(segment_line), output_dir / "segments")
    save_kaldi_text_mapping(utterance_rows(lambda s, _: s.text), output_dir / "text")
    save_kaldi_text_mapping(utterance_rows(lambda s, _: s.speaker), output_dir / "utt2spk")
    save_kaldi_text_mapping(utterance_rows(lambda s, _: s.duration), output_dir / "utt2dur")
    if all(s.language is not None for s in supervisions):
        save_kaldi_text_mapping(utterance_rows(lambda s, _: s.language), output_dir / "utt2lang")
    if all(s.gender is not None for s in supervisions):
        save_kaldi_text_mapping(utterance_rows(lambda s, _: s.gender), output_dir / "utt2gender")


# ---------------------------------------------------------------------------
# Low-level file helpers
# ---------------------------------------------------------------------------
def load_start_and_duration(
    segments_path: Path = None, feats_path: Path = None, frame_shift: Optional[Seconds] = None,
) -> Dict[str, Tuple[float, float]]:
    """
    When both ``segments`` and ``feats.scp`` exist, derive each utterance's
    (start, duration) with the duration taken from the stored feature-matrix
    row count — keeping supervisions aligned with precomputed features.
    """
    out: Dict[str, Tuple[float, float]] = {}
    usable = (
        segments_path.is_file()
        and feats_path.is_file()
        and frame_shift is not None
        and is_module_available("kaldi_native_io")
    )
    if not usable:
        return out
    import kaldi_native_io

    seg_lines = segments_path.read_text().splitlines()
    feat_lines = feats_path.read_text().splitlines()
    for seg_line, feat_line in zip(seg_lines, feat_lines):
        seg_id, _, start, _ = seg_line.split()
        utt_id, ark = feat_line.split(maxsplit=1)
        if seg_id != utt_id:
            raise ValueError(f"{segments_path} and {feats_path} not aligned.")
        rows = kaldi_native_io.MatrixShape.read(ark).num_rows
        out[utt_id] = (float(start), rows * frame_shift)
    return out


def load_kaldi_text_file(path: Path, allow_empty_ref: bool = True) -> Dict[str, str]:
    """The ``text`` file: ``<utt> <transcript>``, transcripts may be empty."""
    if not path.is_file():
        raise ValueError(f"No such file: {path}")
    out = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        if " " in line:
            utt, ref = line.split(maxsplit=1)
            out[utt] = ref
        elif allow_empty_ref:
            out[line] = ""
        else:
            raise ValueError(f"Empty ref. text in: {line} ({path})")
    return out


def load_kaldi_text_mapping(
    path: Path, must_exist: bool = False, float_vals: bool = False) -> Dict[str, Optional[str]]:
    """
    Two-column Kaldi mapping files (utt2spk, spk2gender, ...) as a dict that
    yields None for absent keys (many of these files are optional).
    """
    if not path.is_file():
        if must_exist:
            raise ValueError(f"No such file: {path}")
        return defaultdict(lambda: None)
    pairs = dict(line.strip().split(maxsplit=1) for line in path.open() if line.strip())
    if float_vals:
        pairs = {k: float(v) for k, v in pairs.items()}
    return defaultdict(lambda: None, pairs)


def save_kaldi_text_mapping(data: Dict[str, Any], path: Path):
    """Write a dict as a key-sorted two-column Kaldi mapping file."""
    with path.open("w") as f:
        for key in sorted(data):
            print(key, data[key], file=f)


def make_wavscp_channel_string_map(
    source: AudioSource, sampling_rate: int, transforms: Optional[List[Dict]] = None,
) -> Dict[int, str]:
    """
    Channel -> wav.scp entry for one AudioSource: a plain path when Kaldi can
    read the file directly, otherwise an ffmpeg/sph2pipe conversion pipe.
    """
    if source.type == "url":
        raise ValueError("URL audio sources are not supported by Kaldi.")
    if source.type == "command":
        if len(source.channels) != 1:
            raise ValueError("Command audio multichannel sources are not supported yet.")
        return {0: f"{source.source} |"}
    if source.type != "file":
        raise ValueError(f"Unknown AudioSource type: {source.type}")

    suffix = Path(source.source).suffix
    if suffix == ".wav" and len(source.channels) == 1 and transforms is None:
        # Directly readable; no conversion pipe.
        return {ch: source.source for ch in source.channels}
    if suffix == ".sph":
        # sph2pipe decodes shorten-compressed SPHERE, which ffmpeg cannot.
        return {
            ch: (
                f"sph2pipe {source.source} -f wav -c {ch + 1} -p | "
                f"ffmpeg -threads 1 -i pipe:0 -ar {sampling_rate} "
                f"-f wav -threads 1 pipe:1 |"
            )
            for ch in source.channels
        }
    pick = (lambda ch: "0.0.0") if len(source.channels) == 1 else (lambda ch: f"0.0.{ch}")
    return {
        ch: (
            f"ffmpeg -threads 1 -i {source.source} -ar {sampling_rate} "
            f"-map_channel {pick(ch)}  -f wav -threads 1 pipe:1 |"
        )
        for ch in source.channels
    }
