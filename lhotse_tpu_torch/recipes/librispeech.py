"""
LibriSpeech and Mini LibriSpeech corpus preparation (copied from
``lhotse_tpu/recipes/librispeech.py``).

The corpus layout is ``<split>/<speaker>/<chapter>/``, where each chapter
directory holds FLAC utterances plus a ``<spk>-<chap>.trans.txt`` file with
one ``<utterance-id> <TRANSCRIPT>`` line per utterance.  Optionally, word
alignments from the LibriSpeech-Alignments release are attached. The
manifests are named ``librispeech_{recordings,supervisions}_<part>``; the
supervisions come out in the order of the sorted ``trans.txt`` files and
their lines, the recordings in the same order, as the streaming
``CutSet.from_manifests(lazy=True)`` needs.
"""
import logging
import shutil
import tarfile
import zipfile
from concurrent.futures.thread import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import (Pathlike, is_module_available, resumable_download, safe_extract)

# Split name -> OpenSLR resource number it ships in.
_FULL_SPLITS = {
    "dev-clean": 12, "dev-other": 12, "test-clean": 12, "test-other": 12, "train-clean-100": 12,
    "train-clean-360": 12, "train-other-500": 12}
_MINI_SPLITS = {"dev-clean-2": 31, "train-clean-5": 31}

LIBRISPEECH = tuple(_FULL_SPLITS)
MINI_LIBRISPEECH = tuple(_MINI_SPLITS)

LIBRISPEECH_ALIGNMENTS_URL = ("https://drive.google.com/uc?id=1WYfgr31T-PPwMcxuAq09XZfHQO5Mw8fE")


def _requested_splits(spec: Union[str, Sequence[str]]) -> Sequence[str]:
    if spec == "librispeech":
        return LIBRISPEECH
    if spec == "mini_librispeech":
        return MINI_LIBRISPEECH
    return [spec] if isinstance(spec, str) else spec


def download_librispeech(
    target_dir: Pathlike = ".",
    dataset_parts: Optional[Union[str, Sequence[str]]] = "mini_librispeech",
    force_download: bool = False, alignments: bool = False,
    base_url: str = "http://www.openslr.org/resources",
    alignments_url: str = LIBRISPEECH_ALIGNMENTS_URL) -> Path:
    """
    Fetch + extract (Mini) LibriSpeech tarballs from OpenSLR.

    Each extracted split gets a ``.completed`` marker so re-runs skip it.

    :param dataset_parts: "librispeech", "mini_librispeech", or split name(s).
    :param alignments: additionally fetch the word-alignments zip (gdown).
    :return: the ``LibriSpeech`` corpus directory under ``target_dir``.
    """
    target_dir = Path(target_dir)
    target_dir.mkdir(parents=True, exist_ok=True)
    corpus_dir = target_dir / "LibriSpeech"

    for split in _requested_splits(dataset_parts):
        slr_no = _FULL_SPLITS.get(split) or _MINI_SPLITS.get(split)
        if slr_no is None:
            logging.warning(f"Invalid dataset part name: {split}")
            continue
        logging.info(f"Processing split: {split}")
        marker = corpus_dir / split / ".completed"
        if marker.is_file():
            logging.info(f"Skipping {split} because {marker} exists.")
            continue
        archive = target_dir / f"{split}.tar.gz"
        resumable_download(
            f"{base_url}/{slr_no}/{archive.name}", filename=archive, force_download=force_download)
        shutil.rmtree(corpus_dir / split, ignore_errors=True)
        with tarfile.open(archive) as tar:
            safe_extract(tar, path=target_dir)
        marker.touch()

    if alignments:
        _download_alignments(target_dir, alignments_url, force_download)
    return corpus_dir


def _download_alignments(target_dir: Path, url: str, force: bool) -> None:
    marker = target_dir / ".ali_completed"
    if marker.is_file() and not force:
        return
    if not is_module_available("gdown"):
        raise AssertionError(
            'To download LibriSpeech alignments, please install "pip install gdown"'
        )
    import gdown

    zip_path = str(target_dir / "LibriSpeech-Alignments.zip")
    gdown.download(url, output=zip_path)
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(path=target_dir)
    marker.touch()


def prepare_librispeech(
    corpus_dir: Pathlike, alignments_dir: Optional[Pathlike] = None,
    dataset_parts: Union[str, Sequence[str]] = "auto", output_dir: Optional[Pathlike] = None,
    normalize_text: str = "none", num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Build per-split RecordingSet/SupervisionSet manifests.

    Cached manifests found in ``output_dir`` are returned as-is instead of
    re-scanning audio headers.

    :param dataset_parts: explicit names, "mini_librispeech", or "auto"
        (whatever known splits exist under ``corpus_dir``).
    :param normalize_text: "none" keeps transcripts verbatim; "lower"
        lowercases them.
    :return: ``{split: {"recordings": ..., "supervisions": ...}}``.
    """
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    ali_root = Path(alignments_dir) if alignments_dir is not None else corpus_dir

    present = {p.name for p in corpus_dir.glob("*")}
    if dataset_parts == "auto":
        splits = (set(_FULL_SPLITS) | set(_MINI_SPLITS)) & present
        if not splits:
            raise ValueError(
                f"Could not find any of librispeech or mini_librispeech splits "
                f"in: {corpus_dir}"
            )
    elif dataset_parts == "mini_librispeech":
        splits = set(_MINI_SPLITS) & present
    else:
        splits = _requested_splits(dataset_parts)

    manifests: Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]] = {}
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        manifests = read_manifests_if_cached(
            dataset_parts=splits, output_dir=output_dir, prefix="librispeech")

    with ThreadPoolExecutor(num_jobs) as pool:
        for split in splits:
            logging.info(f"Processing LibriSpeech subset: {split}")
            if manifests_exist(part=split, output_dir=output_dir, prefix="librispeech"):
                logging.info(f"LibriSpeech subset: {split} already prepared - skipping.")
                continue
            recs, sups = _scan_split(corpus_dir, split, ali_root, pool)
            if normalize_text == "lower":
                sups = SupervisionSet.from_segments(s.transform_text(str.lower) for s in sups)
            recs, sups = fix_manifests(recs, sups)
            validate_recordings_and_supervisions(recs, sups)
            if output_dir is not None:
                sups.to_file(output_dir / f"librispeech_supervisions_{split}.jsonl.gz")
                recs.to_file(output_dir / f"librispeech_recordings_{split}.jsonl.gz")
            manifests[split] = {"recordings": recs, "supervisions": sups}

    return manifests


def _scan_split(
    corpus_dir: Path, split: str, ali_root: Path, pool: ThreadPoolExecutor,
) -> Tuple[RecordingSet, SupervisionSet]:
    """Parse every utterance of one split (header reads run on the pool)."""
    split_dir = corpus_dir / split
    jobs = []
    for trans in sorted(split_dir.rglob("*.trans.txt")):
        chapter_ali = (
            ali_root
            / trans.parent.relative_to(corpus_dir)
            / (trans.stem.split(".")[0] + ".alignment.txt")
        )
        word_ali = parse_alignments(chapter_ali) if chapter_ali.exists() else {}
        for line in trans.read_text().splitlines():
            if line.strip():
                jobs.append(pool.submit(parse_utterance, split_dir, line, word_ali))
    recordings, segments = [], []
    for job in jobs:
        parsed = job.result()
        if parsed is not None:
            recordings.append(parsed[0])
            segments.append(parsed[1])
    return (RecordingSet.from_recordings(recordings), SupervisionSet.from_segments(segments))


def parse_utterance(
    dataset_split_path: Path, line: str, alignments: Dict[str, List[AlignmentItem]],
) -> Optional[Tuple[Recording, SupervisionSegment]]:
    """One "<utt-id> <TRANSCRIPT>" line -> (Recording, SupervisionSegment)."""
    utt_id, transcript = line.strip().split(maxsplit=1)
    speaker, chapter, _ = utt_id.split("-", maxsplit=2)
    flac = dataset_split_path / speaker / chapter / f"{utt_id}.flac"
    if not flac.is_file():
        logging.warning(f"No such file: {flac}")
        return None
    recording = Recording.from_file(flac, recording_id=utt_id)
    word_ali = alignments.get(utt_id)
    segment = SupervisionSegment(
        id=utt_id, recording_id=utt_id, start=0.0, duration=recording.duration, channel=0,
        language="English", speaker=speaker, text=transcript.strip(),
        alignment={"word": word_ali} if word_ali is not None else None)
    return recording, segment


def parse_alignments(ali_path: Pathlike) -> Dict[str, List[AlignmentItem]]:
    """
    Read one ``*.alignment.txt``: each line is
    ``<utt-id> "<w1>,<w2>,..." "<t1>,<t2>,..."`` where t_i is the END time of
    word i; word i therefore spans [t_{i-1}, t_i) with t_0 = 0.
    """
    by_utt: Dict[str, List[AlignmentItem]] = {}
    for raw in Path(ali_path).read_text().splitlines():
        if not raw.strip():
            continue
        utt_id, words_field, times_field = raw.split()
        tokens = words_field.strip('"').split(",")
        ends = [float(t) for t in times_field.strip('"').split(",")]
        items = []
        prev = 0.0
        for tok, end in zip(tokens, ends):
            items.append(AlignmentItem(symbol=tok, start=prev, duration=round(end - prev, 8)))
            prev = end
        by_utt[utt_id] = items
    return by_utt
