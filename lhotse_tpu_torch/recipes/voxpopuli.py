"""
VoxPopuli recipe (copied from ``lhotse_tpu/recipes/voxpopuli.py``): European
Parliament speech in 23 languages. The ASR subset is prepared from the
released full-session Ogg Vorbis audio and the per-language annotation TSV
of segment times within the sessions; no segment audio is written::

    raw_audios/<lang>/<year>/<session>_<lang>.ogg
    <output_dir>/asr_<lang>.tsv.gz

The JAX package downloads the annotation TSV into ``output_dir`` (or the
working directory) when it is not there; the port raises
``NotImplementedError`` naming its URL instead. ``download_voxpopuli`` is
not ported: it needs the network.
"""
import csv
import gzip
import logging
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, not_ported

LANGUAGES = (
    "en", "de", "fr", "es", "pl", "it", "ro", "hu", "cs", "nl", "fi", "hr", "sk", "sl", "et", "lt",
    "pt", "bg", "el", "lv", "mt", "sv", "da")
LANGUAGES_V2 = tuple(f"{x}_v2" for x in LANGUAGES)
YEARS = tuple(range(2009, 2021))
ASR_LANGUAGES = (
    "en", "de", "fr", "es", "pl", "it", "ro", "hu", "cs", "nl", "fi", "hr", "sk", "sl", "et", "lt")
# ASR transcriptions also exist for accented English (as in upstream lhotse).
ASR_ACCENTED_LANGUAGES = ("en_accented",)
# Speech-to-speech pairs: any ASR language into the 23 EP languages, with
# human (not auto-aligned) target transcription for en/fr/es
# (as in upstream lhotse).
S2S_SRC_LANGUAGES = ASR_LANGUAGES
S2S_TGT_LANGUAGES = LANGUAGES
S2S_TGT_LANGUAGES_WITH_HUMAN_TRANSCRIPTION = ("en", "fr", "es")
DOWNLOAD_BASE_URL = "https://dl.fbaipublicfiles.com/voxpopuli"

_SUBSET_LANGS = {"400k": LANGUAGES, "100k": LANGUAGES, "10k": LANGUAGES, "asr": ("original",)}
_SUBSET_YEARS = {
    "400k": YEARS + tuple(f"{y}_2" for y in YEARS), "100k": YEARS, "10k": (2019, 2020),
    "asr": YEARS}


class RecordingIdFn:
    """Picklable path -> recording-id mapper (strips language/original affix)."""

    def __init__(self, language: str):
        self.language = language

    def __call__(self, path: Path) -> str:
        rid = re.sub(f"_{self.language}$", "", path.stem)
        return re.sub("_original$", "", rid)


def prepare_voxpopuli(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, task: str = "asr",
    lang: str = "en", source_lang: Optional[str] = None, target_lang: Optional[str] = None,
    num_jobs: int = 1) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    VoxPopuli manifests. Only the "asr" task is currently supported (the
    upstream recipe also stubs out "s2s" and "lm").
    """
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(exist_ok=True, parents=True)
    if task != "asr":
        raise NotImplementedError(f"VoxPopuli task not implemented yet: {task}")
    if lang not in ASR_LANGUAGES:
        raise AssertionError(f"Unsupported language: {lang}")

    manifests = _prepare_asr(corpus_dir, output_dir, lang, num_jobs=num_jobs)
    for split in [s for s, pair in manifests.items() if len(pair["recordings"]) == 0]:
        logging.warning(f"VoxPopuli {lang}/{split} has no recordings; skipping.")
        del manifests[split]
    for split, pair in manifests.items():
        recordings, supervisions = fix_manifests(**pair)
        validate_recordings_and_supervisions(recordings, supervisions)
        pair["recordings"], pair["supervisions"] = recordings, supervisions
        if output_dir is not None:
            recordings.to_file(output_dir / f"voxpopuli-{task}-{lang}_recordings_{split}.jsonl.gz")
            supervisions.to_file(
                output_dir / f"voxpopuli-{task}-{lang}_supervisions_{split}.jsonl.gz"
            )
    return manifests


def _prepare_asr(
    corpus_dir: Path, output_dir: Optional[Path], lang: str, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    logging.info("Preparing recordings (this may take a few minutes)...")
    recordings = RecordingSet.from_dir(
        corpus_dir / "raw_audios" / lang, "*.ogg", num_jobs=num_jobs,
        recording_id=RecordingIdFn(language=lang))

    # Segment annotations ship separately as a per-language TSV.
    url = f"{DOWNLOAD_BASE_URL}/annotations/asr/asr_{lang}.tsv.gz"
    tsv_path = (output_dir or Path(".")) / Path(url).name
    if not tsv_path.exists():
        raise not_ported(f"Downloading the annotation table {url} to {tsv_path}")
    with gzip.open(tsv_path, "rt") as f:
        rows = list(csv.DictReader(f, delimiter="|"))

    per_split = defaultdict(list)
    seg_counter = defaultdict(int)
    for row in rows:
        split = row["split"]
        if split not in ("train", "dev", "test"):
            continue
        rid = row["session_id"]
        begin = float(row["start_time"])
        seg_counter[rid] += 1
        per_split[split].append(
            SupervisionSegment(
                id=f"{rid}-{seg_counter[rid]}",
                recording_id=rid,
                start=round(begin, ndigits=8),
                duration=round(float(row["end_time"]) - begin, ndigits=8),
                channel=0,
                language=lang,
                speaker=row["speaker_id"],
                gender=row["gender"],
                text=row["normed_text"],
                custom={"orig_text": row["original_text"]},
            )
        )

    manifests = {}
    for split in ("train", "dev", "test"):
        wanted = {s.recording_id for s in per_split[split]}
        manifests[split] = {
            "recordings": recordings.filter(lambda r: r.id in wanted),
            "supervisions": SupervisionSet.from_segments(per_split[split])}
    return manifests
