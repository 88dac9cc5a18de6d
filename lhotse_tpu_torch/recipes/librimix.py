"""
LibriMix (copied from ``lhotse_tpu/recipes/librimix.py``): source-separation
mixtures of LibriSpeech clean speech and WHAM! noise, built as *virtual*
mixtures over existing manifests instead of rendering ~430 GB of audio
(https://arxiv.org/pdf/2005.11262.pdf).

Per metadata CSV, a clean and a noisy cut set: the gain-scaled sources are
mixed pairwise, the WHAM! noise is volume-scaled and, where it is shorter
than the mixture, extended with a half-Hanning crossfade; the WHAM! train
set is tripled at speeds 0.8, 1.0 and 1.2. 16 kHz and 'max' mode only.

``download_librimix`` and its GitHub fetchers are not ported: they need the
network. The rows of a CSV are processed in a thread pool and returned in
the CSV's order (the JAX package gathers them as they complete).
"""
import csv
import logging
import os
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet, info, save_audio
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.cut.set import mix
from lhotse_tpu_torch.recipes.utils import manifests_exist, read_manifests_if_cached
from lhotse_tpu_torch.serialization import load_manifest
from lhotse_tpu_torch.utils import Pathlike

RATE = 16000


def _load_wham_recordings(wham_recset_root_path: Pathlike) -> Dict[str, RecordingSet]:
    """WHAM noise manifests per split; train gets 0.8/1.0/1.2 speed variants."""
    wham = {
        key: load_manifest(Path(wham_recset_root_path) / name)
        for key, name in (
            ("train", "wham_recordings_tr.jsonl.gz"),
            ("dev", "wham_recordings_cv.jsonl.gz"),
            ("test", "wham_recordings_tt.jsonl.gz"))}
    wham["train"] = _augment_wham(wham["train"], (0.8, 1.0, 1.2))
    return wham


def _augment_wham(recset: RecordingSet, speed_factors) -> RecordingSet:
    def fix_rec_ids(recording: Recording) -> Recording:
        # "_sp0.8" suffixes become "sp08" to match the metadata naming
        recording.id = re.sub(r"_sp(\d+)\.(\d+)$", r"sp\1\2", recording.id)
        return recording

    variants = []
    for factor in speed_factors:
        augmented = recset if factor == 1.0 else recset.perturb_speed(factor)
        variants.extend(augmented.map(fix_rec_ids))
    return RecordingSet.from_recordings(variants)


def _extend_noise(noise: np.ndarray, max_length: int) -> np.ndarray:
    """Loop the noise with a half-Hanning crossfade until ``max_length``.

    The crossfade is 0.5 s, shrunk for shorter noises (upstream lhotse
    raises a broadcast error on inputs shorter than the crossfade; WHAM!
    noises are all longer, so it never triggers there). Each pass adds
    ``len(noise) - fade - 1`` samples, none for a noise of fewer than three
    samples: that raises (the JAX package loops forever on it).
    """
    if len(noise) < 3 and len(noise) < max_length:
        raise ValueError(
            f"A noise of {len(noise)} samples cannot be extended by crossfading.")
    fade = min(RATE // 2, max(1, (len(noise) - 1) // 2))
    window = np.hanning(2 * fade + 1)
    fade_in = window[: fade + 1]
    fade_out = window[fade::-1]
    out = noise
    while len(out) < max_length:
        out = np.concatenate((
            out[: len(out) - len(fade_out)],
            out[len(out) - len(fade_out):] * fade_out + noise[: len(fade_in)] * fade_in,
            noise[len(fade_in):]))
    return out[:max_length]


def _extend_noise_recording(
    noise_rec: Recording, clean_mix: MonoCut, mixture_id: str,
    workdir: Optional[Path]) -> Recording:
    """Render an extended copy of the noise to disk and re-wrap it."""
    workdir = Path(".") if workdir is None else workdir
    save_to = workdir / f"{noise_rec.id}_{mixture_id}.wav"
    if not save_to.exists():
        noise_array = noise_rec.load_audio()
        if noise_array.ndim > 1:
            noise_array = noise_array[0]
        extended = _extend_noise(
            noise_array, int(clean_mix.duration * clean_mix.sampling_rate))
        save_audio(dest=save_to, src=extended, sampling_rate=noise_rec.sampling_rate)
    meta = info(save_to)
    return Recording(
        id=noise_rec.id,
        sources=[AudioSource(type="file", channels=[0], source=str(save_to))],
        sampling_rate=meta.samplerate, num_samples=meta.frames, duration=meta.duration)


def _process_row(
    row: dict, librispeech_cutset: CutSet, wham_recset: RecordingSet, n_src: int,
    workdir: Optional[Path]):
    """One metadata row -> (clean mixture cut, noisy mixture cut)."""
    src_ids = [Path(row[f"source_{k}_path"]).stem for k in range(1, n_src + 1)]
    gains = [row[f"source_{k}_gain"] for k in range(1, n_src + 1)]
    sources = librispeech_cutset.subset(cut_ids=src_ids)
    scaled = [src.perturb_volume(gain) for src, gain in zip(sources, gains)]
    clean_mix = scaled.pop()
    while scaled:
        clean_mix = mix(clean_mix, scaled.pop())
    clean_mix.id = row["mixture_ID"]

    noise_rec = wham_recset[Path(row["noise_path"]).stem].perturb_volume(row["noise_gain"])
    if noise_rec.duration < clean_mix.duration:
        noise_rec = _extend_noise_recording(
            noise_rec, clean_mix, row["mixture_ID"], workdir)
    noise_cut = MonoCut(
        id="noise", start=0, duration=clean_mix.duration, channel=0, recording=noise_rec)
    noisy_mix = mix(clean_mix, noise_cut, preserve_id="left")
    return clean_mix, noisy_mix


def _read_metadata_csv(csv_path: Path) -> List[dict]:
    rows = []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            for key in row:
                if key.endswith("_gain"):
                    row[key] = float(row[key])
            rows.append(row)
    return rows


def _process_metadata_file(
    md_filename: str, n_src_meta_root: Path, n_src: int, librispeech_root_path: Path,
    wham_recsets: Dict[str, RecordingSet], workdir: Optional[Path],
    num_jobs: int) -> Tuple[List[MonoCut], List[MonoCut]]:
    rows = _read_metadata_csv(n_src_meta_root / md_filename)
    librispeech_cutset = load_manifest(
        Path(librispeech_root_path)
        / md_filename.replace(f"libri{n_src}mix", "librispeech_cutset").replace(
            ".csv", ".jsonl.gz"))
    librispeech_cutset = librispeech_cutset.modify_ids(
        lambda c: "-".join(c.split("-")[:-1]))
    # "libri2mix_train-100.csv" -> "train", "libri2mix_dev.csv" -> "dev" (the
    # JAX package keeps the suffix, "dev.csv", and finds no WHAM! split).
    split_name = "".join(Path(md_filename).stem.split("_")[1:]).split("-")[0]
    wham_recset = wham_recsets[split_name]

    logging.info(f"Processing {md_filename}...")
    with ThreadPoolExecutor(max_workers=num_jobs) as pool:
        mixed = list(pool.map(
            lambda row: _process_row(row, librispeech_cutset, wham_recset, n_src, workdir),
            rows))
    return [clean for clean, _ in mixed], [noisy for _, noisy in mixed]


def prepare_librimix(
    librispeech_root_path: Pathlike, wham_recset_root_path: Pathlike,
    librimix_metadata_path: Pathlike, workdir: Pathlike,
    output_dir: Optional[Pathlike] = None, n_src: int = 2, num_jobs: int = 1,
) -> Dict[str, Dict[str, CutSet]]:
    """Per-split clean/noisy virtual-mixture CutSets off the LibriMix CSVs."""
    logging.warning(
        "The original LibriMix recipe introduces a quantization error when saving "
        "audio files via soundfile (PCM_16). To replicate that exactly, round-trip "
        "the mixed audio through a 16-bit wav file.")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
    if workdir is not None:
        workdir = Path(workdir)
        workdir.mkdir(parents=True, exist_ok=True)

    n_src_meta_root = Path(librimix_metadata_path) / f"Libri{n_src}Mix"
    md_filenames = [
        f for f in os.listdir(n_src_meta_root) if "info" not in f and f != ".completed"]
    # Clean sets are stored and keyed under the bare part name; upstream
    # lhotse reads the cache under '{part}_clean' while writing
    # 'librimix_cutset_{part}.jsonl.gz', so its cached re-runs silently drop
    # every clean cutset from the return value.
    dataset_parts = [
        f"{f.replace('.csv', '')}{suffix}"
        for f in md_filenames for suffix in ("", "_noisy")]
    manifests = read_manifests_if_cached(
        dataset_parts=dataset_parts, output_dir=output_dir, prefix="librimix",
        types=("cutset",)) or {}
    wham_recsets = _load_wham_recordings(wham_recset_root_path)

    for md_filename in md_filenames:
        part_name = md_filename.replace(".csv", "")
        part_name_noisy = f"{part_name}_noisy"
        if all(
            manifests_exist(part=p, output_dir=output_dir, prefix="librimix",
                            types=("cutset",))
            for p in (part_name, part_name_noisy)):
            logging.info(
                f"LibriMix subset: {part_name} and {part_name_noisy} already "
                f"prepared - skipping.")
            continue
        clean_cuts, noisy_cuts = _process_metadata_file(
            md_filename, n_src_meta_root, n_src, librispeech_root_path, wham_recsets,
            workdir, num_jobs)
        for name, cuts in ((part_name, clean_cuts), (part_name_noisy, noisy_cuts)):
            cutset = CutSet.from_cuts(cuts)
            if output_dir is not None:
                cutset.to_file(output_dir / f"librimix_cutset_{name}.jsonl.gz")
            manifests[name] = {"cutset": cutset}
    return manifests
