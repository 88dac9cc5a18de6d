"""
Shar format commands (copied from ``lhotse_tpu/bin/modes/shar.py``).
``compute-features`` with ``-j 1`` runs the shards in this process, so
that the card is started once; more jobs spawn worker processes (the JAX
package forks, which a process that has started CUDA cannot).
"""
import multiprocessing
import random
from concurrent.futures import ProcessPoolExecutor, as_completed
from functools import partial
from pathlib import Path
from typing import List, Optional

import click

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.bin.modes.cli_base import cli
from lhotse_tpu_torch.bin.modes.features import _load_extractor
from lhotse_tpu_torch.utils import Pathlike


@cli.group()
def shar():
    """Shar format for optimized I/O commands."""
    pass


@shar.command(context_settings=dict(show_default=True))
@click.argument("cuts", type=click.Path(exists=True, dir_okay=False))
@click.argument("outdir", type=click.Path())
@click.option(
    "-a", "--audio", default="none",
    type=click.Choice(["none", "wav", "flac", "mp3", "opus", "original"]),
    help="Format in which to export audio (disabled by default; enabling copies the data).")
@click.option(
    "-f", "--features", default="none", type=click.Choice(["none", "lilcom", "numpy"]),
    help="Format in which to export features (disabled by default).")
@click.option(
    "-c", "--custom", multiple=True, default=[],
    help="Custom fields to export as NAME:FORMAT, e.g.: -c target_recording:flac " "-c embedding:numpy; use 'jsonl' for metadata fields.",
)
@click.option("-s", "--shard-size", type=int, default=1000, help="Cuts per shard.")
@click.option(
    "--shuffle/--no-shuffle", default=True, help="Shuffle the cuts before splitting into shards.")
@click.option(
    "--fault-tolerant/--fast-fail", default=False,
    help="Skip cuts that failed to load data instead of raising.")
@click.option("--seed", default=0, type=int, help="Random seed.")
@click.option(
    "-j", "--num-jobs", default=1, type=int,
    help="Number of parallel workers (keep low on slow disks).")
@click.option(
    "--compress-jsonl/--no-compress-jsonl", default=True,
    help="Gzip the cuts jsonl shards; use --no-compress-jsonl to enable " "exact indexed restore.")
@click.option("-v", "--verbose", count=True)
def export(
    cuts: str, outdir: str, audio: str, features: str, custom: List[str], shard_size: int,
    shuffle: bool, fault_tolerant: bool, seed: int, num_jobs: int, compress_jsonl: bool,
    verbose: bool):
    """
    Export CutSet from CUTS into the Shar format in OUTDIR (shards of
    SHARD_SIZE cuts + sequential-read tars per data field). Readable with
    CutSet.from_shar(OUTDIR).
    """
    cut_set: CutSet = CutSet.from_file(cuts)
    if shuffle:
        cut_set = cut_set.shuffle(rng=random.Random(seed))

    fields = dict(item.split(":") for item in custom)
    for field, fmt in (("recording", audio), ("features", features)):
        if fmt != "none":
            fields[field] = fmt

    Path(outdir).mkdir(parents=True, exist_ok=True)
    cut_set.to_shar(
        output_dir=outdir, fields=fields, shard_size=shard_size, num_jobs=num_jobs,
        fault_tolerant=fault_tolerant, verbose=bool(verbose), compress_jsonl=compress_jsonl)


@shar.command(context_settings=dict(show_default=True))
@click.argument("shar_dir", type=click.Path(exists=True, file_okay=False))
@click.option(
    "-f", "--feature-config", type=click.Path(exists=True, dir_okay=False),
    help="Optional manifest specifying feature extractor configuration " "(Fbank by default).")
@click.option(
    "-c", "--compression", type=click.Choice(["lilcom", "numpy"]), default="numpy",
    help="Compression (lilcom is lossy, numpy is lossless).")
@click.option("-j", "--num-jobs", default=1, type=int, help="Number of parallel workers.")
@click.option("-v", "--verbose", count=True)
def compute_features(
    shar_dir: str, feature_config: Optional[str], compression: str, num_jobs: int, verbose: int):
    """
    Compute features for Shar cuts stored in SHAR_DIR, parallelized across
    shards (extends the dataset with features.*.tar archives).
    """
    def shard_spec(cuts_path: Path) -> dict:
        audio_tar = "".join(["recording", cuts_path.suffixes[0], ".tar"])
        return {"cuts": [cuts_path], "recording": [cuts_path.with_name(audio_tar)]}

    cut_shards = [p for p in Path(shar_dir).glob("cuts.*.jsonl*") if p.suffix != ".idx"]
    progbar = lambda x: x
    if verbose:
        import tqdm

        click.echo(f"Computing features for {len(cut_shards)} shards.")
        progbar = partial(tqdm.tqdm, desc="Shard progress", total=len(cut_shards))

    def one_shard(cuts_path: Path) -> dict:
        shard_idx = cuts_path.name.split(".")[1]
        return dict(
            cuts=CutSet.from_shar(shard_spec(cuts_path)), feature_config=feature_config,
            output_path=cuts_path.with_name(f"features.{shard_idx}.tar"), compression=compression)

    if num_jobs == 1:
        for cuts_path in progbar(cut_shards):
            compute_features_one_shard(**one_shard(cuts_path))
        return
    with ProcessPoolExecutor(num_jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(compute_features_one_shard, **one_shard(p)) for p in cut_shards]
        for job in progbar(as_completed(jobs)):
            job.result()


def compute_features_one_shard(
    cuts: CutSet, feature_config: Pathlike, output_path: Pathlike, compression: str):
    from lhotse_tpu_torch.features.io import MemoryRawWriter
    from lhotse_tpu_torch.shar import ArrayTarWriter

    extractor = _load_extractor(feature_config)
    scratch = MemoryRawWriter()
    with ArrayTarWriter(output_path, shard_size=None, compression=compression) as writer:
        for cut in cuts:
            cut = cut.compute_and_store_features(extractor, scratch)
            writer.write(key=cut.id, value=cut.load_features(), manifest=cut.features)
