"""
TED-LIUM release 2 recipe (openslr/19; copied from
``lhotse_tpu/recipes/tedlium2.py``): TED talks as SPHERE audio with STM
transcripts in ``<split>/{sph,stm}``. The STM parsing and text
normalization are the TED-LIUM 3 recipe's. ``download_tedlium2`` is not
ported: it needs the network.
"""
import logging
from concurrent.futures.thread import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.recipes.tedlium import _parse_stm_file
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

TEDLIUM2_PARTS = ("train", "dev", "test")


def prepare_tedlium2(
    tedlium_root: Pathlike, output_dir: Optional[Pathlike] = None,
    dataset_parts: Union[str, Sequence[str]] = TEDLIUM2_PARTS, num_jobs: int = 1,
    normalize_text: str = "none") -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-split TED-LIUM 2 manifests (SPHERE audio, parsed STM segments)."""
    tedlium_root = Path(tedlium_root)
    if isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]
    parse = partial(_parse_stm_file, normalize_text=normalize_text)

    corpus = {}
    with ThreadPoolExecutor(num_jobs) as pool:
        for split in dataset_parts:
            logging.info(f"Processing {split} split...")
            root = tedlium_root / split
            recordings = RecordingSet.from_dir(root / "sph", pattern="*.sph", num_jobs=num_jobs)
            stms = sorted((root / "stm").glob("*.stm"))
            if len(stms) != len(recordings):
                raise AssertionError(
                    f"Mismatch: found {len(recordings)} sphere files and "
                    f"{len(stms)} STM files. You might be missing some parts "
                    f"of TEDLIUM..."
                )
            segments = []
            for result in pool.map(parse, stms):
                segments.extend(result)
            corpus[split] = finalize_manifests(
                recordings, segments, output_dir=output_dir, prefix="tedlium2", part=split)
    return corpus
