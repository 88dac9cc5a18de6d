"""
CHiME-6 (copied from ``lhotse_tpu/recipes/chime6.py``): dinner-party
conversations recorded with binaural headsets (ihm) and six 4-channel
Kinect arrays (mdm), 20 sessions.

``prepare_chime6`` reads the *array-synchronised* CHiME-6 distribution::

    CHiME6/
      audio/{train,dev,eval}/S??_P??.wav      # binaural headsets (2ch each)
      audio/{train,dev,eval}/S??_U0?.CH?.wav  # array channels
      transcriptions/{train,dev,eval}/S??.json

Each transcription entry has HH:MM:SS.mmm start/end times, speaker, words,
and (dev/eval) the reference array. The mic variants, the CHiME-7 split
option and the text-normalisation modes are the JAX package's. With
``perform_array_sync=True`` it first makes that layout from the raw
CHiME-5 one with ``Chime6ArraySynchronizer`` (frame-drop surgery, clock
drift, transcription times), driven by the challenge's
``chime6_audio_edits.json``.

Not ported: ``download_chime6``, and the two downloads of the synchroniser
and the checksum check (they need the network). The edits file must be
given, or lie at ``<output_dir>/audio_edits.json`` of the synchroniser
(``<output_dir>/CHiME6/audio_edits.json`` of ``prepare_chime6``), and
``verify_md5_checksums`` needs its ``checksum_file``; where the JAX package
would download them, the port raises ``NotImplementedError``, and so does
``prepare_chime6(verify_md5_checksums=True)``, which always downloads the
list.
"""
import hashlib
import json
import logging
import os
import re
import shutil
import subprocess
import tempfile
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet, info as audio_info
from lhotse_tpu_torch.audio.wavio import read_wav, write_wav
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, add_durations, not_ported

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

# Where the challenge publishes the synchroniser's edits and the checksums of
# the synchronised corpus; the port reads local copies of both.
CHIME6_AUDIO_EDITS_JSON = "https://raw.githubusercontent.com/chimechallenge/chime6-synchronisation/master/chime6_audio_edits.json"
CHIME6_MD5SUM_FILE = "https://raw.githubusercontent.com/chimechallenge/chime6-synchronisation/master/audio_md5sums.txt"


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


def verify_md5_checksums(
    corpus_dir: Pathlike, num_workers: int = 1, sessions: Optional[Sequence[str]] = None,
    checksum_file: Optional[Pathlike] = None) -> bool:
    """
    Compare MD5 checksums of every ``*.wav`` under ``corpus_dir`` against the
    official post-synchronization checksum list (``CHIME6_MD5SUM_FILE``, a
    local copy in ``checksum_file``). Files absent from the list pass;
    ``sessions`` restricts the sweep.
    """
    if checksum_file is None:
        raise not_ported(
            f"Downloading the CHiME-6 checksum list ({CHIME6_MD5SUM_FILE}); pass checksum_file")
    corpus_dir = Path(corpus_dir)
    expected = {}
    for line in Path(checksum_file).read_text().splitlines():
        if not line.strip():
            continue
        digest, name = line.strip().split(maxsplit=1)
        expected[Path(name).stem] = digest

    wavs = sorted(corpus_dir.rglob("*.wav"))
    if sessions is not None:
        keep = set(sessions)
        wavs = [w for w in wavs if w.stem.split("_")[0] in keep]

    def ok(wav: Path) -> bool:
        want = expected.get(wav.stem)
        return want is None or hashlib.md5(wav.read_bytes()).hexdigest() == want

    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        return all(pool.map(ok, wavs))


class Chime6ArraySynchronizer:
    """
    Produce the array-synchronized CHiME-6 corpus from raw CHiME-5 data:
    per-array frame-drop correction, per-device clock-drift correction, and
    transcription timestamp adjustment, driven by the challenge's published
    ``chime6_audio_edits.json`` (modelled on
    github.com/chimechallenge/chime6-synchronisation).

    Clock-drift correction is bit-exact with the official corpus only when a
    sox v14.4.2 binary is available (the official tool); without sox it
    falls back to linear-interpolation warping (audio perceptually identical,
    but MD5 checksums will not match the official list).

    :param audio_edits: the edits mapping, a path to a local copy of the JSON,
        or None to read ``output_dir/audio_edits.json`` (the JAX package
        downloads it there when it is missing; the port raises).
    """

    def __init__(
        self, corpus_dir: Pathlike, output_dir: Pathlike, sox_path: Pathlike = "sox",
        num_workers: int = 1,
        audio_edits: Optional[Union[Dict[str, dict], Pathlike]] = None) -> None:
        # Resolve both roots: headset files are passed through as symlinks,
        # and a relative source path would dangle (it resolves relative to
        # the symlink's own directory, not the caller's CWD).
        self.corpus_dir = Path(corpus_dir).resolve()
        self.output_dir = Path(output_dir).resolve()
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.sox_path = str(sox_path)
        self.num_workers = max(int(num_workers), 1)
        if isinstance(audio_edits, dict):
            self.audio_edits = audio_edits
        else:
            if audio_edits is None:
                audio_edits = self.output_dir / "audio_edits.json"
                if not Path(audio_edits).is_file():
                    raise not_ported(
                        f"Downloading the CHiME-6 audio edits ({CHIME6_AUDIO_EDITS_JSON}) to "
                        f"{audio_edits}; put a local copy there or pass audio_edits")
            self.audio_edits = json.loads(Path(audio_edits).read_text())

    def synchronize_session(self, session: str) -> None:
        """Run all three correction stages for one session (e.g. ``"S02"``)."""
        edits = self.audio_edits.get(session)
        if edits is None:
            logging.warning(f"No audio edits for session {session}; skipping.")
            return
        work_dir = Path(tempfile.mkdtemp(prefix=f"chime6_{session}_", dir=self.output_dir))
        try:
            self._correct_frame_drops(work_dir, session, edits)
            self._correct_clock_drift(work_dir, session, edits)
            self._adjust_transcription_times(session, edits)
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)

    # -- stage 1: frame drops ------------------------------------------------

    def _correct_frame_drops(self, work_dir: Path, session: str, edits: dict) -> None:
        audio_root = self.corpus_dir / "audio"
        # Binaural headset wavs have no frame drops: link them through.
        for wav in sorted(audio_root.rglob(f"{session}_P*.wav")):
            dst = work_dir / wav.relative_to(self.corpus_dir)
            dst.parent.mkdir(parents=True, exist_ok=True)
            os.symlink(wav, dst)
        # Array channels are corrected jointly per device so every channel
        # receives identical sample-index surgery.
        by_array: Dict[str, list] = defaultdict(list)
        for wav in sorted(audio_root.rglob(f"{session}_U*.wav")):
            by_array[wav.stem.split(".")[0].split("_")[-1]].append(wav)
        for array_id, wavs in by_array.items():
            fit = edits.get(array_id)
            if fit is None or "edits" not in fit:
                logging.warning(
                    f"Array {array_id} in session {session} has no frame-drop edits.")
                continue
            loaded = [read_wav(w) for w in wavs]
            rate = loaded[0][1]
            x = np.concatenate([samples for samples, _ in loaded], axis=0)
            fixed = self._apply_edits(x, fit["edits"])
            for row, wav in zip(fixed, wavs):
                dst = work_dir / wav.relative_to(self.corpus_dir)
                dst.parent.mkdir(parents=True, exist_ok=True)
                write_wav(dst, row[None, :], rate)

    @staticmethod
    def _apply_edits(channels: np.ndarray, edits: Sequence[Sequence[int]]) -> np.ndarray:
        """
        Apply frame-drop surgery: each edit ``[in_from, in_to, out_from]``
        (1-based, inclusive) copies that input span to the output position,
        leaving silence where frames were dropped.
        """
        length = channels.shape[1]
        last = edits[-1]
        out = np.zeros((channels.shape[0], last[2] + last[1] - last[0]), dtype=channels.dtype)
        out_to = 0
        for in_from, in_to, out_from in edits:
            if in_from > length:
                break
            in_to = min(in_to, length)
            out_to = out_from + in_to - in_from
            out[:, out_from - 1 : out_to] = channels[:, in_from - 1 : in_to]
        return out[:, :out_to]

    # -- stage 2: clock drift ------------------------------------------------

    def _correct_clock_drift(self, work_dir: Path, session: str, edits: dict) -> None:
        jobs = []
        for wav in sorted((work_dir / "audio").rglob(f"{session}_*.wav")):
            mic_id = wav.stem.split(".")[0].split("_")[-1]
            fit = edits.get(mic_id)
            if fit is None or "speed" not in fit:
                logging.warning(
                    f"Device {mic_id} in session {session} has no clock-drift fit.")
                continue
            dst = self.output_dir / wav.relative_to(work_dir)
            dst.parent.mkdir(parents=True, exist_ok=True)
            jobs.append((wav, dst, fit))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            list(pool.map(lambda job: self._warp_file(*job), jobs))

    def _sox_available(self) -> bool:
        if not hasattr(self, "_sox_ok"):
            try:
                version = subprocess.check_output(
                    [self.sox_path, "--version"], stderr=subprocess.STDOUT).decode()
                self._sox_ok = True
                if "14.4.2" not in version:
                    logging.warning(
                        f"sox reports {version.strip()!r}, not the official v14.4.2 — "
                        "synchronized audio may differ from the released corpus.")
            except (OSError, subprocess.CalledProcessError):
                self._sox_ok = False
        return self._sox_ok

    def _warp_file(self, src: Path, dst: Path, fit: dict) -> None:
        speeds, padding = fit["speed"], fit["padding"]
        if self._sox_available():
            self._warp_with_sox(src, dst, speeds, padding)
        else:
            logging.warning(
                "sox not found: applying native clock-drift warp (MD5 checksums "
                "will not match the official corpus).")
            self._warp_native(src, dst, speeds, padding)

    def _warp_with_sox(self, src: Path, dst: Path, speeds, padding) -> None:
        sox = [self.sox_path, "-D", "-R"]  # no dither, no random seed
        if not isinstance(speeds, list):
            cmd = sox + [str(src), str(dst), "speed", str(speeds)]
            cmd += (["pad", f"{padding}s", "0s"] if padding > 0 else ["trim", f"{-padding}s"])
            subprocess.check_call(cmd)
            return
        # Piecewise fit (S01 arrays): warp each segment, then concatenate.
        starts = list(padding)
        ends = starts[1:] + [-1]
        pieces = []
        carry = 0.0
        with tempfile.TemporaryDirectory(dir=self.output_dir) as tmp:
            for seg, (start, end, speed) in enumerate(zip(starts, ends, speeds)):
                cut = Path(tmp) / f"seg{seg}.wav"
                out = Path(tmp) / f"seg{seg}.warped.wav"
                cmd = sox + [str(src), str(cut)]
                if seg == 0:
                    # Either way the segment is `end - |start|` samples: a
                    # negative boundary trims, a positive one pads.
                    cmd += (["trim", f"{-start}s"] if start < 0
                            else ["pad", f"{start}s", "0s", "trim", "0s"])
                    duration = end - abs(start) if end > 0 else -1
                else:
                    start += carry
                    cmd += ["trim", f"{int(start)}s"]
                    duration = end - start if end > 0 else -1
                if duration > 0:
                    cmd += [f"{int(duration)}s"]
                if speed < 0:
                    # Backwards fit: these samples are dropped and the deficit
                    # is consumed from the start of the next segment.
                    carry = -duration / speed
                    continue
                carry = 0.0
                subprocess.check_call(cmd)
                subprocess.check_call(sox + [str(cut), str(out), "speed", str(speed)])
                pieces.append(str(out))
            subprocess.check_call(sox + pieces + [str(dst)])

    def _warp_native(self, src: Path, dst: Path, speeds, padding) -> None:
        x, rate = read_wav(src)
        if not isinstance(speeds, list):
            y = self._linear_warp(x, speeds)
            y = (np.pad(y, ((0, 0), (padding, 0))) if padding > 0 else y[:, -padding:])
            write_wav(dst, y, rate)
            return
        starts = list(padding)
        ends = starts[1:] + [-1]
        pieces = []
        carry = 0.0
        for seg, (start, end, speed) in enumerate(zip(starts, ends, speeds)):
            if seg == 0:
                piece = (x[:, -start:] if start < 0
                         else np.pad(x, ((0, 0), (start, 0))))
                stop = end - abs(start) if end > 0 else piece.shape[1]
                piece = piece[:, :stop]
                duration = stop
            else:
                begin = int(start + carry)
                stop = end if end > 0 else x.shape[1]
                piece = x[:, begin:stop]
                duration = stop - begin
            if speed < 0:
                carry = -duration / speed
                continue
            carry = 0.0
            pieces.append(self._linear_warp(piece, speed))
        write_wav(dst, np.concatenate(pieces, axis=1), rate)

    @staticmethod
    def _linear_warp(x: np.ndarray, speed: float) -> np.ndarray:
        """Resample by a factor ~1 via linear interpolation (fallback path)."""
        n_out = int(x.shape[1] / speed)
        pos = np.arange(n_out) * speed
        base = np.arange(x.shape[1], dtype=np.float64)
        return np.stack([np.interp(pos, base, row) for row in x]).astype(x.dtype)

    # -- stage 3: transcription timestamps -----------------------------------

    def _adjust_transcription_times(self, session: str, edits: dict) -> None:
        src = next((self.corpus_dir / "transcriptions").rglob(f"{session}.json"))
        dst = self.output_dir / src.relative_to(self.corpus_dir)
        dst.parent.mkdir(parents=True, exist_ok=True)
        adjusted = []
        for seg in json.loads(src.read_text()):
            if "speaker" not in seg:
                continue
            fit = edits.get(seg["speaker"])
            for key in ("start_time", "end_time"):
                stamp = seg[key]["original"] if isinstance(seg[key], dict) else seg[key]
                if fit is None:
                    seg[key] = stamp  # audio was not warped either
                else:
                    seg[key] = seconds_to_hms(
                        hms_to_seconds(stamp) / fit["speed"] + fit["padding"] / 16000.0)
            if fit is None:
                logging.warning(
                    f"Speaker {seg['speaker']} in session {session} has no "
                    "clock-drift fit; keeping original timestamps.")
            adjusted.append(seg)
        dst.write_text(json.dumps(adjusted, indent=2))


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
    :param perform_array_sync: run :class:`Chime6ArraySynchronizer` over the
        raw (CHiME-5) corpus first, writing the synchronized corpus to
        ``output_dir/CHiME6`` and preparing manifests from it; the edits are
        read from ``output_dir/CHiME6/audio_edits.json``.
    :param verify_md5_checksums: verify the synchronized audio against the
        official checksum list, which the JAX package downloads: the port
        raises ``NotImplementedError`` (call ``verify_md5_checksums`` with a
        local ``checksum_file`` instead).
    :param num_jobs: parallel sessions for array sync / checksum workers.
    :param num_threads_per_job: threads per session for clock-drift warps.
    :param sox_path: sox v14.4.2 binary used for bit-exact clock-drift warps.
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

    if verify_md5_checksums:
        # The JAX package fetches the list after the sync; nothing is synced
        # for a run that cannot finish.
        raise not_ported(
            f"Downloading the CHiME-6 checksum list ({CHIME6_MD5SUM_FILE}) for "
            "verify_md5_checksums=True; call verify_md5_checksums with a checksum_file")

    sessions = [s for part in dataset_parts for s in split[part]]
    if perform_array_sync:
        if not output_dir:
            raise ValueError("`perform_array_sync=True` requires `output_dir`.")
        synced_dir = Path(output_dir) / "CHiME6"
        synchronizer = Chime6ArraySynchronizer(
            corpus_dir=corpus_dir, output_dir=synced_dir, sox_path=sox_path,
            num_workers=num_threads_per_job)
        with ThreadPoolExecutor(max_workers=min(max(num_jobs, 1), len(sessions))) as pool:
            list(pool.map(synchronizer.synchronize_session, sessions))
        corpus_dir = synced_dir

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
