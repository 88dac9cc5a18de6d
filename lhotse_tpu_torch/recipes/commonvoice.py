"""
Mozilla CommonVoice recipe, crowd-sourced multilingual read speech: MP3
clips and per-split TSV metadata (copied from
``lhotse_tpu/recipes/commonvoice.py``).

A release holds one directory per language, with ``{split}.tsv`` files
(``client_id``, ``path``, ``sentence``, ``age``, ``gender``, ``accents``
columns; quotes are not balanced, so the TSVs are read with
``QUOTE_NONE``) and the clips under ``clips/``. The clips are probed on a
thread pool through the MP3 backend. ``download_commonvoice`` is not
ported.
"""
import csv
import logging
from collections import defaultdict
from concurrent.futures.thread import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.serialization import load_manifest
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

DEFAULT_COMMONVOICE_RELEASE = "cv-corpus-13.0-2023-03-09"

COMMONVOICE_LANGS = (
    "en de fr cy tt kab ca zh-TW it fa eu es ru tr nl eo zh-CN rw pt zh-HK "
    "cs pl uk"
).split()
COMMONVOICE_SPLITS = ("train", "dev", "test", "validated", "invalidated", "other")
COMMONVOICE_DEFAULT_SPLITS = ("test", "dev", "train")


def _parse_utterance(
    lang_path: Path, language: str, audio_info: Dict[str, str],
) -> Optional[Tuple[Recording, SupervisionSegment]]:
    audio_path = lang_path / "clips" / audio_info["path"]
    if not audio_path.is_file():
        logging.info(f"No such file: {audio_path}")
        return None
    recording_id = Path(audio_info["path"]).stem
    recording = Recording.from_file(path=audio_path, recording_id=recording_id)
    segment = SupervisionSegment(
        id=recording_id, recording_id=recording_id, start=0.0, duration=recording.duration,
        channel=0, language=language, speaker=audio_info.get("client_id"),
        text=(audio_info.get("sentence") or "").strip(), gender=audio_info.get("gender"),
        custom={ "age": audio_info.get("age"), "accents": audio_info.get("accents"), "variant": audio_info.get("variant"), },
    )
    return recording, segment


def _prepare_part(
    lang: str, part: str, lang_path: Pathlike, num_jobs: int = 1,
) -> Tuple[RecordingSet, SupervisionSet]:
    """One split of one language: read {part}.tsv, probe the referenced clips."""
    lang_path = Path(lang_path)
    tsv_path = lang_path / f"{part}.tsv"
    with open(tsv_path) as f:
        # QUOTE_NONE: the CV TSVs contain unbalanced quotes.
        rows = list(csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE))
    recordings, supervisions = [], []
    with ThreadPoolExecutor(num_jobs) as ex:
        for result in ex.map(lambda row: _parse_utterance(lang_path, lang, row), rows):
            if result is None:
                continue
            recordings.append(result[0])
            supervisions.append(result[1])
    return (RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(supervisions))


def prepare_commonvoice(
    corpus_dir: Pathlike, output_dir: Pathlike, languages: Union[str, Sequence[str]] = "auto",
    splits: Union[str, Sequence[str]] = COMMONVOICE_DEFAULT_SPLITS, num_jobs: int = 1,
) -> Dict[str, Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]]:
    """
    Prepare manifests: ``result[language][split] = {recordings, supervisions}``.

    :param corpus_dir: the release directory (contains per-language dirs).
    :param languages: "auto" scans the corpus dir; else code(s) like "en".
    """
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(splits, str):
        splits = [splits]
    if languages == "auto":
        languages = sorted(
            d.name for d in corpus_dir.iterdir() if d.is_dir() and (d / "clips").is_dir()
        )
    elif isinstance(languages, str):
        languages = [languages]

    manifests = defaultdict(dict)
    for lang in languages:
        logging.info(f"Processing CommonVoice language: {lang}")
        lang_path = corpus_dir / lang
        for part in splits:
            rec_path = output_dir / f"cv_recordings_{lang}_{part}.jsonl.gz"
            sup_path = output_dir / f"cv_supervisions_{lang}_{part}.jsonl.gz"
            if rec_path.is_file() and sup_path.is_file():
                logging.info(f"Skipping {lang}/{part} - already prepared.")
                manifests[lang][part] = {
                    "recordings": load_manifest(rec_path), "supervisions": load_manifest(sup_path)}
                continue
            recordings, supervisions = _prepare_part(lang, part, lang_path, num_jobs=num_jobs)
            recordings, supervisions = fix_manifests(recordings, supervisions)
            validate_recordings_and_supervisions(recordings, supervisions)
            recordings.to_file(rec_path)
            supervisions.to_file(sup_path)
            manifests[lang][part] = {"recordings": recordings, "supervisions": supervisions}
    return dict(manifests)
