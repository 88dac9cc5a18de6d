"""
LibriSpeechMix (copied from ``lhotse_tpu/recipes/librispeechmix.py``):
multi-speaker mixtures of LibriSpeech utterances from the published
metadata (speaker combinations and delays),
https://github.com/NaoyukiKanda/LibriSpeechMix/. One CutSet per metadata
JSONL: the source cuts, looked up by recording id and left-padded by their
delay, mixed pairwise with the first cut's id kept.

``download_librispeechmix`` is not ported: it needs the network. The
entries of a file are processed in a thread pool and returned in the file's
order (the JAX package gathers them as they complete).
"""
import glob
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.cut.set import mix
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.utils import Pathlike

RATE = 16000


def _mixture_from_entry(entry: dict, librispeech_cutset: CutSet) -> Optional[MonoCut]:
    """Build one delayed multi-speaker mixture cut from a metadata entry."""
    mixture_id = entry["id"].split("/")[-1]
    delays = entry["delays"]
    source_cuts = []
    for i, wav_path in enumerate(entry["wavs"]):
        cut = librispeech_cutset[Path(wav_path).stem]
        delay = delays[i] if i < len(delays) else 0.0
        if delay > 0:
            cut = cut.pad(delay + cut.duration, direction="left")
        source_cuts.append(cut)
    if len(source_cuts) != len(entry["wavs"]):
        raise ValueError("Not all mono cuts collected")
    mixed = source_cuts[0]
    for cut in source_cuts[1:]:
        mixed = mix(mixed, cut, preserve_id="left")
    mixed.id = mixture_id
    return mixed


def _process_metadata_file(
    metadata_file: str, librispeech_cutset: CutSet, num_jobs: int) -> List[MonoCut]:
    entries = [
        json.loads(line)
        for line in Path(metadata_file).read_text().splitlines() if line.strip()]
    logging.info(f"Processing {len(entries)} entries from {metadata_file}...")
    with ThreadPoolExecutor(max_workers=num_jobs) as pool:
        mixed = pool.map(lambda e: _mixture_from_entry(e, librispeech_cutset), entries)
        return [cut for cut in mixed if cut is not None]


def prepare_librispeechmix(
    librispeech_root_path: Pathlike, librispeechmix_metadata_path: Pathlike,
    output_dir: Optional[Pathlike] = None, num_jobs: Optional[int] = 1,
) -> Dict[str, Dict[str, CutSet]]:
    """One virtual-mixture CutSet per metadata JSONL file."""
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    metadata_files = glob.glob(f"{librispeechmix_metadata_path}/*.jsonl")
    dataset_parts = [Path(f).stem for f in metadata_files]
    manifests = read_manifests_if_cached(
        dataset_parts=dataset_parts, output_dir=output_dir, prefix="librispeechmix",
        types=("cutset",)) or {}

    for metadata_file in metadata_files:
        part_name = Path(metadata_file).stem
        if manifests_exist(
                part=part_name, output_dir=output_dir, prefix="librispeechmix",
                types=("cutset",)):
            logging.info(f"LibriSpeechMix subset: {part_name} already prepared - skipping.")
            continue
        logging.info(f"Processing {part_name}...")
        split = "-".join(part_name.split("-")[:-1])
        librispeech_cutset = CutSet.from_file(
            Path(librispeech_root_path) / f"librispeech_cutset_{split}.jsonl.gz")

        def use_recording_id(cut):
            cut.id = cut.recording_id
            return cut

        librispeech_cutset = librispeech_cutset.map(use_recording_id).to_eager()
        cuts = _process_metadata_file(metadata_file, librispeech_cutset, num_jobs)
        cutset = CutSet.from_cuts(cuts)
        if output_dir is not None:
            cutset.to_file(output_dir / f"librispeechmix_cutset_{part_name}.jsonl.gz")
        manifests[part_name] = {"cutset": cutset}
    return manifests
