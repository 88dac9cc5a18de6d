"""
TED-LIUM release 3 recipe (openslr/51; copied from
``lhotse_tpu/recipes/tedlium.py``): TED talks as 16 kHz NIST SPHERE files
with STM transcripts, in the legacy train/dev/test repartition
(``legacy/<split>/{sph,stm}``).

STM lines marked ``ignore_time_segment_in_scoring`` are dropped and
``{NOISE}`` becomes ``[NOISE]``; the text normalization follows Kaldi's
TED-LIUM recipe. ``download_tedlium`` is not ported: it needs the network.
"""
import logging
import re
from concurrent.futures.thread import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

TEDLIUM_PARTS = ("train", "dev", "test")


def normalize_text_tedlium(text: str, normalize: str = "upper") -> str:
    """Kaldi-TEDLIUM-style text normalization (none / upper / kaldi)."""
    if normalize == "none":
        return text
    if normalize == "upper":
        return text.upper()
    if normalize == "kaldi":
        text = re.sub(r"\[[^\]]+\]", "", text)  # [NOISE] etc.
        text = re.sub(r"<unk>", "", text)
        text = re.sub(r"(\w+) '(\w+)", r"\1'\2", text)  # they 're -> they're
        text = re.sub(r"' (\w+)", r"'\1", text)  # ' cause -> 'cause
        return text.strip()
    raise ValueError(f"Unknown text normalization: {normalize}")


def _parse_stm_file(stm: Path, normalize_text: str = "none") -> List[SupervisionSegment]:
    segments = []
    with stm.open() as f:
        for idx, line in enumerate(f):
            rec_id, _, _, start, end, _, *words = line.split()
            start, end = float(start), float(end)
            text = " ".join(words).replace("{NOISE}", "[NOISE]")
            if text == "ignore_time_segment_in_scoring":
                continue
            segments.append(
                SupervisionSegment(
                    id=f"{rec_id}-{idx}",
                    recording_id=rec_id,
                    start=start,
                    duration=round(end - start, ndigits=8),
                    channel=0,
                    text=normalize_text_tedlium(text, normalize_text),
                    language="English",
                    speaker=rec_id,
                )
            )
    return segments


def prepare_tedlium(
    tedlium_root: Pathlike, output_dir: Optional[Pathlike] = None,
    dataset_parts: Union[str, Sequence[str]] = TEDLIUM_PARTS, num_jobs: int = 1,
    normalize_text: str = "none") -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Prepare train/dev/test manifests from the legacy TED-LIUM 3 layout."""
    tedlium_root = Path(tedlium_root)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]

    corpus = {}
    with ThreadPoolExecutor(num_jobs) as ex:
        for split in dataset_parts:
            logging.info(f"Processing {split} split...")
            root = tedlium_root / "legacy" / split
            recordings = RecordingSet.from_dir(root / "sph", pattern="*.sph", num_jobs=num_jobs)
            stms = sorted((root / "stm").glob("*.stm"))
            assert len(stms) == len(recordings), (
                f"Mismatch: found {len(recordings)} sphere files and "
                f"{len(stms)} STM files. You might be missing some parts "
                f"of TEDLIUM..."
            )
            worker = partial(_parse_stm_file, normalize_text=normalize_text)
            segments = []
            for result in ex.map(worker, stms):
                segments.extend(result)
            supervisions = SupervisionSet.from_segments(segments)
            recordings, supervisions = fix_manifests(recordings, supervisions)
            corpus[split] = {"recordings": recordings, "supervisions": supervisions}
            validate_recordings_and_supervisions(**corpus[split])
            if output_dir is not None:
                recordings.to_file(output_dir / f"tedlium_recordings_{split}.jsonl.gz")
                supervisions.to_file(output_dir / f"tedlium_supervisions_{split}.jsonl.gz")
    return corpus
