"""
WHAM! noise corpus (copied from ``lhotse_tpu/recipes/wham.py``): ambient
noise recordings (restaurants, bars, parks) used to contaminate
wsj0-2mix into the WHAM/WHAMR source-separation data.

Layout: ``wham_noise/{tr,cv,tt}/*.wav``. Recording manifests only; there
is no text. ``download_wham`` is not ported: it needs the network.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def prepare_wham(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-split (tr/cv/tt) WHAM! noise recording manifests."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    manifests = {}
    for split in ("tr", "cv", "tt"):
        logging.info(f"Scanning {split} split...")
        recordings = RecordingSet.from_recordings(
            Recording.from_file(w) for w in (corpus_dir / split).rglob("*.wav")
        )
        validate(recordings)
        manifests[split] = {"recordings": recordings}
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for split, entry in manifests.items():
            for key, manifest in entry.items():
                manifest.to_file(output_dir / f"wham_{key}_{split}.jsonl.gz")
    return manifests
