"""
MGB-2 recipe (copied from ``lhotse_tpu/recipes/mgb2.py``): 1,200 h of
multi-genre Arabic broadcast (Aljazeera) with ASR-aligned captions, and
about 20 h of verbatim dev and test (https://arabicspeech.org/mgb2/). Dev
and test come as Kaldi data directories with ``.non_overlap_speech`` text
and segments in BuckWalter transliteration; train comes as one XML file
per programme, filtered by each segment's WMER, and parsed with
``xml.etree.ElementTree`` under a raised recursion limit. The supervision
counts of the full corpus are checked with a warning, so that subsets can
be prepared. ``download_mgb2`` is not ported: the corpus is obtained
through a form.
"""
import logging
import re
import xml.etree.ElementTree as ET
from itertools import chain
from pathlib import Path
from shutil import copy
from string import punctuation
from typing import Dict, List, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.kaldi import load_kaldi_data_dir
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob, recursion_limit

_EXPECTED_COUNTS = {"test": 5365, "dev": 5002, "train": 375103}


def prepare_mgb2(
    corpus_dir: Pathlike, output_dir: Pathlike, text_cleaning: bool = True,
    buck_walter: bool = False, num_jobs: int = 1, mer_thresh: int = 80,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Build dev/train/test manifests.  ``output_dir`` is mandatory: manifests
    are flushed while processing because the train part is large.
    """
    corpus_dir = Path(corpus_dir)
    output_dir = Path(output_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    output_dir.mkdir(parents=True, exist_ok=True)
    dataset_parts = ["dev", "train", "test"]
    manifests = read_manifests_if_cached(
        dataset_parts=dataset_parts, output_dir=output_dir, prefix="mgb2",
        suffix="jsonl.gz", lazy=True) or {}

    for part in dataset_parts:
        if manifests_exist(part=part, output_dir=output_dir, prefix="mgb2", suffix="jsonl.gz"):
            logging.info(f"MGB2 subset: {part} already prepared - skipping.")
            continue
        logging.info(f"Processing MGB2 subset: {part}")
        if part in ("dev", "test"):
            recordings, supervisions = _prepare_eval_part(corpus_dir, output_dir, part)
            if not buck_walter:
                supervisions = supervisions.transform_text(from_buck_walter)
        else:
            recordings, supervisions = _prepare_train_part(corpus_dir, num_jobs, mer_thresh)
            if text_cleaning:
                supervisions = supervisions.transform_text(cleaning)
        expected = _EXPECTED_COUNTS[part]
        if len(supervisions) != expected:
            logging.warning(
                f"Expected {expected} supervisions for {part}, found {len(supervisions)}")
        recordings, supervisions = fix_manifests(recordings, supervisions)
        validate_recordings_and_supervisions(recordings, supervisions)
        recordings.to_file(output_dir / f"mgb2_recordings_{part}.jsonl.gz")
        supervisions.to_file(output_dir / f"mgb2_supervisions_{part}.jsonl.gz")
        manifests[part] = {"recordings": recordings, "supervisions": supervisions}
    return manifests


def _prepare_eval_part(corpus_dir: Path, output_dir: Path, part: str):
    """dev/test ship as Kaldi dirs; materialize one with absolute wav paths."""
    staged = output_dir / part
    staged.mkdir(parents=True, exist_ok=True)
    copy(corpus_dir / part / "text.non_overlap_speech", staged / "text")
    copy(corpus_dir / part / "segments.non_overlap_speech", staged / "segments")
    with open(corpus_dir / part / "wav.scp") as f_in, open(staged / "wav.scp", "w") as f_out:
        for line in f_in:
            f_out.write(line.replace("wav/", f"{corpus_dir}/{part}/wav/"))
    recordings, supervisions, _ = load_kaldi_data_dir(staged, 16000)
    return recordings, supervisions


def _prepare_train_part(corpus_dir: Path, num_jobs: int, mer_thresh: int):
    recordings = RecordingSet.from_dir(
        corpus_dir / "train" / "wav", pattern="*.wav", num_jobs=num_jobs)
    xml_paths = check_and_rglob(corpus_dir / "train" / "xml/utf8", "*.xml")
    with recursion_limit(5000):
        supervisions = SupervisionSet.from_segments(
            chain.from_iterable(make_supervisions(p, mer_thresh) for p in xml_paths))
    return recordings, supervisions


# --- BuckWalter transliteration (standard table) -----------------------------
_unicode = (
    "آؤئبتجگخذز"
    "شضظغـقلنويٌَ"
    "ِْٰپچءأإڤاةث"
    "حدرسصطعفكمهى"
    "ًٍُّٱ")
_buckwalter = "|&}btjGx*z$DZg_qlnwyNaio`PJ'><VApvHdrsSTEfkmhYFKu~{"
_backward_map = {ord(b): a for a, b in zip(_unicode, _buckwalter)}


def from_buck_walter(s: str) -> str:
    return s.translate(_backward_map)


# --- ESPNet-style text cleaning ----------------------------------------------
_ARABIC_PUNCT = """﴿﴾`÷×؛<>_()*&^%][ـ،/:"؟.,'{}~¦+|!”…“–ـ"""
_EAST_TO_WEST = str.maketrans(
    {"٠": "0", "١": "1", "٢": "2", "٣": "3", "٤": "4", "٥": "5", "٦": "6", "٧": "7",
     "٨": "8", "٩": "9", "٪": "%", "_": " ", "ڤ": "ف", "|": " "})


def remove_diacritics(text: str) -> str:
    return re.sub(r"[ً-ْ۔ٰٴە-ۭ]+", "", text)


def remove_punctuations(text: str) -> str:
    for p in set(_ARABIC_PUNCT + punctuation):
        text = text.replace(p, " ")
    return text


def remove_non_alphanumeric(text: str) -> str:
    return re.sub(r"[^؀-ۿ\s\da-z]+", "", text.lower())


def remove_single_char_word(text: str) -> str:
    return " ".join(w for w in text.split() if len(w) > 1 or w.isnumeric())


def east_to_west_num(text: str) -> str:
    return text.translate(_EAST_TO_WEST)


def remove_extra_space(text: str) -> str:
    return re.sub(r"\s+\.\s+", ".", re.sub(r"\s+", " ", text))


def cleaning(text: str) -> str:
    for step in (remove_punctuations, east_to_west_num, remove_diacritics,
                 remove_non_alphanumeric, remove_single_char_word, remove_extra_space):
        text = step(text)
    return text


def make_supervisions(xml_path: Pathlike, mer_thresh: int) -> List[SupervisionSegment]:
    """Per-segment supervisions from one MGB-2 program XML (WMER-filtered)."""
    root = ET.parse(str(xml_path)).getroot()
    out = []
    for segment in root.iter("segment"):
        if mer_thresh is not None and float(segment.get("WMER")) > mer_thresh:
            continue
        start = float(segment.get("starttime"))
        end = float(segment.get("endtime"))
        words = [el.text for el in segment.iter("element") if el.text is not None]
        seg_id = segment.get("id")
        out.append(
            SupervisionSegment(
                id=f"{seg_id}_{segment.get('starttime')}:{segment.get('endtime')}",
                recording_id=seg_id.split("_utt")[0].replace("_", "-"),
                start=start, duration=round(end - start, ndigits=8), channel=0,
                text=" ".join(words), language="Arabic",
                speaker=int(re.match(r"\w+speaker(\d+)\w+", segment.get("who")).group(1))))
    return out
