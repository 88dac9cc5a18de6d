"""
IWSLT 2022 Tunisian Arabic recipe (copied from
``lhotse_tpu/recipes/iwslt22_ta.py``): three-way parallel conversational
telephone speech (LDC2022E01), 8 kHz SPHERE audio with Tunisian transcripts
and English translations, split by the official lists of
github.com/kevinduh/iwslt22-dialect. Transcripts and translations are
per-file TSVs paired by segment id; the utterances of
``exclude-utterance.txt`` are dropped, and each supervision carries its
translation in ``custom["translated_text"]``. The optional cleaning chain
of the IWSLT'22 paper normalises the Arabic text.

The upstream recipe shadows its ``normalize_text`` helper with a bool
parameter, which makes the marker filter unreachable; here the filter is
:func:`filter_markers` and always applies, as in the JAX package.
``download_iwslt22_ta`` downloads nothing: it logs where the corpus and the
split lists come from.
"""
import logging
import re
import string
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.mgb2 import east_to_west_num, remove_diacritics
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

_ARABIC_FILTER = re.compile(r"[OUM]+/*|؟|\?|\!|\.")
_ENGLISH_FILTER = re.compile(r"\(|\)|\#|\+|\=|\?|\!|\;|\.|\,|\"|\:")


def download_iwslt22_ta(target_dir: Pathlike = ".") -> None:
    """No direct download; points at the LDC catalog + split repo."""
    logging.info(
        "To obtain this data your institution needs to have an LDC subscription. "
        "You also should download the pre-defined splits with "
        "git clone https://github.com/kevinduh/iwslt22-dialect.git")


def filter_markers(utterance: str, language: str) -> str:
    """Drop the annotation markers (upstream lhotse's ``normalize_text``)."""
    if language == "transcript":
        return _ARABIC_FILTER.sub("", utterance)
    if language == "translation":
        return _ENGLISH_FILTER.sub("", utterance).lower()
    raise ValueError(f"Text normalization for {language} is not supported")


def load_splits(path: Path) -> Dict[str, List[str]]:
    return {
        split: [
            line.strip()
            for line in (path / f"{split}.file_id.txt").read_text().splitlines()
            if line.strip()]
        for split in ("train", "dev", "test1")}


def deduplicate_supervisions(
    supervisions: Iterable[SupervisionSegment]) -> List[SupervisionSegment]:
    by_id = defaultdict(list)
    for s in sorted(supervisions, key=lambda s: s.id):
        by_id[s.id].append(s)
    filtered = []
    for sid, group in by_id.items():
        if len(group) > 1:
            logging.warning(
                f"Found {len(group)} supervisions with conflicting IDs ({sid}) "
                f"- keeping only the first one.")
        filtered.append(group[0])
    return filtered


# --- Arabic text cleaning (IWSLT'22 paper recipe) ----------------------------
_PRE_NORM = " ةىأإآ"
_POST_NORM = " هيااا"
_CHAR_NORM = {ord(b): a for a, b in zip(_POST_NORM, _PRE_NORM)}
_ARABIC_PUNCT = """`÷×؛<>_()*&^%][ـ،/:"؟.,'{}~¦+|!”…“–ـ"""


def normalize_text_(s: str) -> str:
    return s.translate(_CHAR_NORM)


def normalize_arabic(text: str) -> str:
    text = re.sub("[إأٱآا]", "ا", text)
    for ch in "أاآصو":
        text = re.sub(rf"({ch}){{2,}}", "ا" if ch in "أاآ" else ch, text)
    return text


def remove_punctuations(text: str) -> str:
    for p in set(_ARABIC_PUNCT + string.punctuation):
        text = text.replace(p, " ")
    return text


def remove_extra_space(text: str) -> str:
    return re.sub(r"\s+\.\s+", ".", re.sub(r"\s+", " ", text))


def text_cleaning(text: str) -> str:
    for step in (remove_punctuations, east_to_west_num, remove_diacritics,
                 remove_extra_space, normalize_arabic, normalize_text_):
        text = step(text)
    return text


def _filename_to_supervisions(
    p: Path, translations_path: Path, normalize: bool, exclude: list, langs: list):
    supervisions = []
    stem = p.with_suffix("").stem
    date, time, someid, channel = stem.split("_")
    transcripts = sorted(
        p.read_text().splitlines(), key=lambda line: line.split("\t")[0])
    translations = sorted(
        translations_path.read_text().splitlines(), key=lambda line: line.split("\t")[0])
    for src, tgt in zip(transcripts, translations):
        start, end, sid, text = src.rstrip().split("\t")
        _, _, _, text_tgt = tgt.rstrip().split("\t")
        start, end = float(start), float(end)
        text = filter_markers(text, "transcript")
        text_tgt = filter_markers(text_tgt, "translation")
        utt_id = f"{date}_{time}_{someid}_{channel}_{int(100 * start):06}"
        if normalize:
            text = text_cleaning(text)
            if text.strip() == "":
                logging.warning(
                    f"Skipping {p.stem} {start} {end} with empty cleaned transcript ...")
                continue
        if utt_id in exclude:
            continue
        supervisions.append(
            SupervisionSegment(
                id=f"{sid}_{langs[0]}_{langs[1]}_{utt_id}", recording_id=stem,
                start=start, duration=round(end - start, ndigits=8), channel=0,
                text=text, language=langs[0], speaker=sid,
                custom={"translated_text": {langs[1]: text_tgt}}))
    return supervisions


def prepare_iwslt22_ta(
    corpus_dir: Pathlike, splits: Pathlike, output_dir: Optional[Pathlike] = None,
    normalize_text: bool = False, langs: Optional[List[str]] = ["ta", "eng"],
    num_jobs: int = 1) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """train/dev/test1 manifests off LDC2022E01 + the official split lists."""
    corpus_dir = Path(corpus_dir)
    splits = Path(splits)
    split_files = load_splits(splits)
    audio_dir = corpus_dir / "data/audio/ta"
    text_dir = corpus_dir / "data/transcripts/ta"

    exclude = []
    for line in (splits / "exclude-utterance.txt").read_text().splitlines():
        if line.strip():
            excludeid, start, _end = line.strip().split()
            exclude.append(f"{excludeid}_{int(100 * float(start)):06}")

    recordings = {}
    supervisions = []
    for p in sorted(text_dir.glob("*.tsv")):
        if p.stem.startswith("._"):
            continue
        translations_path = (
            p.parent.parent.parent / "translations" / "ta"
            / (p.stem.split(".")[0] + ".eng" + p.suffix))
        if not translations_path.exists():
            logging.warning(
                f"{translations_path.stem} does not exist, please make sure "
                f"number of translations = transcriptions")
            continue
        filename = p.with_suffix("").stem
        if filename not in recordings:
            recordings[filename] = Recording.from_file(
                audio_dir / f"{filename}.sph", recording_id=filename)
        supervisions.extend(
            _filename_to_supervisions(
                p, translations_path, normalize_text, exclude, langs))

    supervisions = SupervisionSet.from_segments(deduplicate_supervisions(supervisions))
    recording_set = RecordingSet.from_recordings(recordings.values())
    recording_set, supervisions = fix_manifests(recording_set, supervisions)
    validate_recordings_and_supervisions(recording_set, supervisions)

    manifests = {}
    for split in ("train", "dev", "test1"):
        wanted = set(split_files[split])
        sups_ = supervisions.filter(lambda s: s.recording_id in wanted)
        recs_ = recording_set.filter(lambda r: r.id in wanted)
        manifests[split] = {"recordings": recs_, "supervisions": sups_}
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            recs_.to_file(output_dir / f"iwslt22-ta_recordings_{split}.jsonl.gz")
            sups_.to_file(output_dir / f"iwslt22-ta_supervisions_{split}.jsonl.gz")
    return manifests
