"""
KeSpeech recipe (copied from ``lhotse_tpu/recipes/kespeech.py``): 1,542 h of
Mandarin and 8 subdialects from 27k speakers, 16 kHz WAV
(https://openreview.net/forum?id=b3Zoeq2sCLq). Each part is a Kaldi-style
``Tasks/ASR/<part>/`` directory (``wav.scp``, ``text``, ``utt2subdialect``,
``utt2spk``) whose files are read in step, line by line; a line whose ids
differ raises. The supervision's language is the subdialect, and
``<SPOKEN_NOISE>`` is stripped from the text. The headers are probed on a
thread pool of ``num_jobs`` and taken in submission order, so the manifests
are the same at any ``num_jobs``. The corpus is obtained manually.
"""
import logging
from concurrent.futures.thread import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import (
    finalize_manifests, manifests_exist, read_manifests_if_cached)
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

KE_SPEECH_PARTS = ("train_phase1", "train_phase2", "dev_phase1", "dev_phase2", "test")


def text_normalize(line: str) -> str:
    return line.replace("<SPOKEN_NOISE>", "")


def _parse_utterance(corpus_dir: Path, wav_line, text_line, dialect_line, spk_line,
                     ) -> Optional[Tuple[Recording, SupervisionSegment]]:
    wav_id, wav_path = wav_line.strip().split(maxsplit=1)
    t_id, transcript = text_line.strip().split(maxsplit=1)
    d_id, dialect = dialect_line.strip().split(maxsplit=1)
    s_id, speaker = spk_line.strip().split(maxsplit=1)
    if not (wav_id == t_id == d_id == s_id):
        raise AssertionError(f"Misaligned KeSpeech task files at utterance {wav_id}")
    recording = Recording.from_file(corpus_dir / wav_path, recording_id=wav_id)
    segment = SupervisionSegment(
        id=wav_id, recording_id=wav_id, start=0.0, duration=recording.duration,
        text=text_normalize(transcript.strip()), language=dialect, speaker=speaker)
    return recording, segment


def prepare_kespeech(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    dataset_parts: Union[str, Sequence[str]] = "all", num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Build per-part manifests off the Kaldi-style Tasks/ASR directory."""
    corpus_dir = Path(corpus_dir)
    tasks_dir = corpus_dir / "Tasks" / "ASR"
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    assert tasks_dir.is_dir(), f"No such directory: {tasks_dir}"

    if isinstance(dataset_parts, str):
        dataset_parts = (dataset_parts,)
    subsets = KE_SPEECH_PARTS if "all" in dataset_parts else tuple(dataset_parts)
    unknown = set(subsets) - set(KE_SPEECH_PARTS)
    if unknown:
        raise ValueError(f"No such part of dataset in KeSpeech : {sorted(unknown)[0]}")

    manifests = read_manifests_if_cached(
        dataset_parts=subsets, output_dir=output_dir, prefix="kespeech-asr") or {}

    with ThreadPoolExecutor(num_jobs) as pool:
        for part in subsets:
            if manifests_exist(part=part, output_dir=output_dir, prefix="kespeech-asr"):
                logging.info(f"KeSpeech subset: {part} already prepared - skipping.")
                continue
            logging.info(f"Processing KeSpeech subset: {part}")
            part_path = tasks_dir / part
            with open(part_path / "wav.scp") as wav_scp, \
                    open(part_path / "text") as text, \
                    open(part_path / "utt2subdialect") as utt2subdialect, \
                    open(part_path / "utt2spk") as utt2spk:
                jobs = [
                    pool.submit(_parse_utterance, corpus_dir, *quad)
                    for quad in zip(wav_scp, text, utt2subdialect, utt2spk)]
            parsed = [j.result() for j in jobs]
            recordings = [r for r, _ in parsed if r is not None]
            supervisions = [s for _, s in parsed if s is not None]
            manifests[part] = finalize_manifests(
                recordings, supervisions, output_dir=output_dir,
                prefix="kespeech-asr", part=part)
    return manifests
