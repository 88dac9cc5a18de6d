"""
Manifest manipulation commands: copy, split, subset, combine, filter, ...
(copied from ``lhotse_tpu/bin/modes/manipulation.py``). ``copy-feats``
copies the features of a CutSet one stored file per job: with one job it
runs in this process, with more it spawns worker processes (the JAX package
forks).
"""
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, as_completed
from itertools import groupby
from pathlib import Path
from typing import Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import cli
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.features import FeatureSet
from lhotse_tpu_torch.features.io import (
    available_storage_backends, default_features_storage_backend_name, get_writer)
from lhotse_tpu_torch.serialization import load_manifest_lazy_or_eager
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["split", "combine", "subset", "filter"]

_MANIFEST_ARG = click.argument(
    "manifest", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
_OUTPUT_ARG = click.argument("output_manifest", type=click.Path(allow_dash=True))


@cli.command()
@click.argument("input_manifest", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@_OUTPUT_ARG
def copy(input_manifest, output_manifest):
    """
    Load INPUT_MANIFEST and store it to OUTPUT_MANIFEST — converts between
    serialization formats (JSON/JSONL/YAML, with .gz compression).
    """
    load_manifest_lazy_or_eager(input_manifest).to_file(output_manifest)


def _copy_cut_features_parallel(
    cuts: CutSet, storage_path: str, storage_type: str, max_jobs: int, output_manifest) -> None:
    """Group cuts by their underlying feature file and copy file-groups in
    parallel worker processes (in this process when there is one)."""
    from lhotse_tpu_torch.manipulation import combine as combine_manifests

    by_file = [
        CutSet.from_cuts(group)
        for _, group in groupby(
            sorted(cuts, key=lambda cut: cut.features.storage_path),
            lambda cut: cut.features.storage_path,
        )
    ]
    workers = len(by_file) if max_jobs <= 0 else min(len(by_file), max_jobs)

    root = Path(storage_path)
    if root.parent.is_dir():
        root.mkdir(exist_ok=True)

    jobs = [(group, f"{storage_path}/feats-{i}", storage_type, f"{storage_path}/cuts-{i}.jsonl.gz")
            for i, group in enumerate(by_file)]
    if workers == 1:
        merged = combine_manifests(copy_feats_worker(*job) for job in jobs)
    else:
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [pool.submit(copy_feats_worker, *job) for job in jobs]
            merged = combine_manifests(f.result() for f in as_completed(futures))

    with CutSet.open_writer(output_manifest) as writer:
        for cut in merged:
            writer.write(cut)


@cli.command()
@click.argument("input_manifest", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@_OUTPUT_ARG
@click.argument("storage_path", type=str)
@click.option(
    "-t", "--storage-type", type=click.Choice(available_storage_backends()),
    default=default_features_storage_backend_name(),
    help="Backend used to write the copied features.")
@click.option(
    "-j", "--max-jobs", default=-1, type=int,
    help="Cap on parallel copy processes (default: one per existing feature file).")
def copy_feats(
    input_manifest: Pathlike, output_manifest: Pathlike, storage_path: str, storage_type: str,
    max_jobs: int) -> None:
    """
    Read every feature matrix from INPUT_MANIFEST (FeatureSet or CutSet),
    save them in STORAGE_PATH, and write the updated OUTPUT_MANIFEST.
    """
    manifests = load_manifest_lazy_or_eager(input_manifest)
    if isinstance(manifests, FeatureSet):
        with get_writer(storage_type)(storage_path) as writer:
            manifests.copy_feats(writer=writer).to_file(output_manifest)
    elif isinstance(manifests, CutSet):
        _copy_cut_features_parallel(
            manifests, storage_path, storage_type, max_jobs, output_manifest)
    else:
        raise ValueError(f"Unsupported manifest type ({type(manifests)}) at: {input_manifest}")


def copy_feats_worker(
    cuts: CutSet, storage_path: Pathlike, storage_type: str, output_manifest: Path) -> CutSet:
    with get_writer(storage_type)(storage_path) as w:
        return cuts.copy_feats(writer=w, output_path=output_manifest)


@cli.command()
@click.argument("num_splits", type=int)
@_MANIFEST_ARG
@click.argument("output_dir", type=click.Path())
@click.option(
    "-s", "--shuffle", is_flag=True, help="Optionally shuffle the sequence before splitting.")
@click.option(
    "--pad/--no-pad", default=True,
    help="Pad the split output idx with zeros (e.g. 00, 01, 02, .., 10).")
@click.option(
    "-i", "--start-idx", type=int, default=0, help="Count splits starting from this index.")
def split(
    num_splits: int, manifest: Pathlike, output_dir: Pathlike, shuffle: bool, pad: bool,
    start_idx: int):
    """
    Split MANIFEST into NUM_SPLITS equal parts saved in OUTPUT_DIR.
    For very large manifests, prefer "lhotse-tpu-torch split-lazy".
    """
    manifest = Path(manifest)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    suffix = "".join(manifest.suffixes)
    width = len(str(num_splits))

    whole = load_manifest_lazy_or_eager(manifest)
    for idx, part in enumerate(
        whole.split(num_splits=num_splits, shuffle=shuffle), start=start_idx):
        tag = str(idx).zfill(width) if pad else str(idx)
        part.to_file((out / manifest.stem).with_suffix(f".{tag}{suffix}"))


@cli.command()
@_MANIFEST_ARG
@click.argument("output_dir", type=click.Path(allow_dash=True))
@click.argument("chunk_size", type=int)
@click.option(
    "-i", "--start-idx", type=int, default=0, help="Count splits starting from this index.")
def split_lazy(manifest: Pathlike, output_dir: Pathlike, chunk_size: int, start_idx: int):
    """
    Split MANIFEST lazily into parts of CHUNK_SIZE items saved as
    "{output_dir}/{manifest.stem}.{chunk_idx}.jsonl.gz".
    """
    manifest = Path(manifest)
    load_manifest_lazy_or_eager(manifest).split_lazy(
        output_dir=Path(output_dir), chunk_size=chunk_size, prefix=manifest.stem,
        start_idx=start_idx)


def _parse_cut_ids(cutids: Optional[str]):
    """--cutids accepts inline JSON or a path to a JSON file."""
    if cutids is None:
        return None
    if os.path.exists(cutids):
        with open(cutids, "rt") as f:
            return json.load(f)
    return json.loads(cutids)


@cli.command()
@_MANIFEST_ARG
@_OUTPUT_ARG
@click.option("--first", type=int)
@click.option("--last", type=int)
@click.option(
    "--cutids", type=str,
    help=( "A json string or path to json file containing array of cutids strings. " 'E.g. --cutids \'["cutid1", "cutid2"]\'.' ),
)
def subset(
    manifest: Pathlike, output_manifest: Pathlike, first: Optional[int], last: Optional[int],
    cutids: Optional[str]):
    """Select the FIRST or LAST items of MANIFEST into OUTPUT_MANIFEST."""
    whole = load_manifest_lazy_or_eager(Path(manifest))
    cids = _parse_cut_ids(cutids)

    if isinstance(whole, CutSet):
        picked = whole.subset(first=first, last=last, cut_ids=cids)
    elif cids is not None:
        raise ValueError(f"Expected a CutSet manifest with cut_ids argument; got {type(whole)}")
    else:
        picked = whole.subset(first=first, last=last)
    picked.to_file(Path(output_manifest))


@cli.command()
@click.argument(
    "manifests", nargs=-1, type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@_OUTPUT_ARG
def combine(manifests: Pathlike, output_manifest: Pathlike):
    """Combine MANIFESTS into a single one written to OUTPUT_MANIFEST."""
    from lhotse_tpu_torch.manipulation import combine as combine_manifests

    merged = combine_manifests(*(load_manifest_lazy_or_eager(m) for m in manifests))
    merged.to_file(output_manifest)


@cli.command()
@click.argument("predicate")
@_MANIFEST_ARG
@_OUTPUT_ARG
def filter(predicate: str, manifest: Pathlike, output_manifest: Pathlike):
    """
    Filter a MANIFEST by PREDICATE into OUTPUT_MANIFEST. Works with
    RecordingSet, SupervisionSet and CutSet.

    \b
    PREDICATE compares a numeric attribute, e.g.:
    lhotse-tpu-torch filter 'duration>4.5' supervision.json output.json
    lhotse-tpu-torch filter 'num_frames<600' cuts.json output.json
    """
    import operator
    import re
    from math import isclose

    from lhotse_tpu_torch.manipulation import to_manifest

    match = re.fullmatch(r"(?P<key>\w+)(?P<op>==?|!=|>=?|<=?)(?P<value>[0-9.]+)", predicate)
    if match is None:
        raise ValueError(
            "Invalid predicate! Run with --help option to learn what "
            "predicates are allowed."
        )
    key, op, raw = match.group("key", "op", "value")
    compare = {
        "<": operator.lt, ">": operator.gt, ">=": operator.ge, "<=": operator.le, "=": isclose,
        "==": isclose, "!=": lambda a, b: not isclose(a, b)}[op]
    threshold = float(raw) if "." in raw else int(raw)

    kept = []
    for item in load_manifest_lazy_or_eager(manifest):
        try:
            attr = getattr(item, key)
        except AttributeError:
            click.echo(
                f'Invalid predicate! Items in "{manifest}" do not have the ' f'attribute "{key}"',
                err=True)
            exit(1)
        if compare(attr, threshold):
            kept.append(item)

    survivors = to_manifest(kept)
    if survivors is None:
        click.echo("No items satisfying the predicate.", err=True)
        exit(0)
    survivors.to_file(output_manifest)
