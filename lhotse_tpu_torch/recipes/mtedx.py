"""
Multilingual TEDx recipe (copied from ``lhotse_tpu/recipes/mtedx.py``):
transcribed and translated TED talks in 8 languages (openslr/100); this
recipe prepares the ASR portion. Each language package holds per-split
FLAC directories and VTT transcripts. The VTT clean-up turns noise spans
into ``<noise>``, makes apostrophes typographic, removes HTML tags, keeps
the valid Unicode categories and lower-cases; a word with an invalid
character becomes ``<unk>``. Unicode spaces are normalised with
``unicodedata`` instead of the optional ``regex`` package.
``download_mtedx`` is not ported: it needs the network.
"""
import logging
import re
import unicodedata
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

VALID_CATEGORIES = ("Mc", "Mn", "Ll", "Lm", "Lo", "Lt", "Lu", "Nd", "Zs")
KEEP_LIST = ["\u2019"]

ASR = ("es", "fr", "pt", "it", "ru", "el", "ar", "de")

ISOCODE2LANG = {
    "fr": "French", "es": "Spanish", "pt": "Portuguese", "it": "Italian",
    "ru": "Russian", "el": "Greek", "ar": "Arabic", "de": "German"}

_NOISE_SPAN = re.compile(r"\([^)]*\)")
_APOSTROPHE = re.compile(r"(\w)'(\w)")
_HTML_TAGS = re.compile(r"(&[^ ;]*;)|(</?[iu]>)")


def _resolve_languages(languages) -> Sequence[str]:
    if isinstance(languages, str):
        return list(ISOCODE2LANG) if languages == "all" else [languages]
    languages = list(languages)
    return list(ISOCODE2LANG) if languages and languages[0] == "all" else languages


def prepare_mtedx(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    languages: Optional[Union[str, Sequence[str]]] = "all", num_jobs: int = 1,
) -> Dict[str, Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]]:
    """Per-language, per-split manifests for every requested language."""
    corpus_dir = Path(corpus_dir)
    output_dir = Path(output_dir) if output_dir is not None else None
    manifests = {}
    for lang in _resolve_languages(languages):
        corpus_dir_lang = corpus_dir / f"{lang}-{lang}"
        if corpus_dir_lang.is_dir():
            manifests[lang] = prepare_single_mtedx_language(
                corpus_dir_lang,
                output_dir / lang if output_dir is not None else None,
                language=lang, num_jobs=num_jobs)
    return manifests


def prepare_single_mtedx_language(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    language: str = "language", num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """train/valid/test manifests for one language package."""
    corpus_dir = Path(corpus_dir)
    manifests = {}
    for split in ("train", "valid", "test"):
        audio_dir = corpus_dir / f"data/{split}/wav"
        recordings = RecordingSet.from_recordings(
            Recording.from_file(p) for p in sorted(audio_dir.glob("*.flac")))
        if len(recordings) == 0:
            logging.warning(f"No .flac files found in {audio_dir}")
        supervisions = []
        text_dir = corpus_dir / f"data/{split}/vtt"
        for p in sorted(text_dir.glob("*")):
            result = _filename_to_supervisions(p, language)
            if result:
                supervisions.extend(result)
        if not supervisions:
            logging.warning(f"No supervisions found in {text_dir}")
        manifests[split] = finalize_manifests(
            recordings, supervisions, output_dir=output_dir,
            prefix=f"mtedx-{language}", part=split)
    return manifests


def _filename_to_supervisions(filename: Path, language: str):
    recoid = filename.stem.split(".")[0]
    supervisions = []
    for start, end, line in _parse_vtt(filename.read_text(), "<noise>"):
        words = []
        for w in line.split():
            w = w.strip()
            if re.match(r"^(\([^)]*\) *)+$", w) or _filter_word(w):
                words.append(w)
            else:
                words.append("<unk>")
        line_ = " ".join(words)
        # drop lines that mix words with markup beyond a leading word + tags
        if "<" in line_ or ">" in line_:
            if not re.match(r"^\w+ *(<[^>]*> *)+$", line_, re.UNICODE):
                continue
        supervisions.append(
            SupervisionSegment(
                id=_format_uttid(recoid, start), recording_id=recoid, start=start,
                duration=round(end - start, ndigits=8), channel=0, text=line_.strip(),
                language=language, speaker=recoid))
    return supervisions


def _format_uttid(recoid, start) -> str:
    return f"{recoid}_{int(float(start) * 100):08d}"


def _filter_word(s: str) -> bool:
    return all(_filter(c) for c in s)


def _filter(c: str) -> bool:
    return unicodedata.category(c) in VALID_CATEGORIES or c in KEEP_LIST


def _time2sec(time: str) -> float:
    hr, mn, sec = time.split(":")
    return int(hr) * 3600.0 + int(mn) * 60.0 + float(sec)


def _parse_time_segment(line: str):
    start, end = line.split(" --> ")
    return _time2sec(start), _time2sec(end)


def _clean_part(part: str) -> str:
    """Keep only valid-category characters of one between-noise span."""
    return "".join(c for c in part.strip().replace("-", " ") if _filter(c))


def _parse_vtt(lines: str, noise: str):
    for block in lines.split("\n\n"):
        if block.strip() == "":
            continue
        b_lines = block.split("\n")
        # locate the cue timing row (robust to numeric cue ids and headers)
        timing_idx = next(
            (k for k, ln in enumerate(b_lines) if " --> " in ln), None)
        if timing_idx is None:
            continue
        start, end = _parse_time_segment(b_lines[timing_idx])
        line = " ".join(b_lines[timing_idx + 1:])
        line_new = line
        if line.strip("- ") != "":
            marked = _NOISE_SPAN.sub(noise, line_new)
            marked = _APOSTROPHE.sub("\\1\u2019\\2", marked)
            marked = _HTML_TAGS.sub("", marked)
            joiner = " " + noise + " "
            line_new = joiner.join(_clean_part(p) for p in marked.split(noise))
            line_new = "".join(
                " " if unicodedata.category(c) == "Zs" else c for c in line_new)
            line_new = re.sub(r" +", " ", line_new).strip().lower()
        yield start, end, line_new
