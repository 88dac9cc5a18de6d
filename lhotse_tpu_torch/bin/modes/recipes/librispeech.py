"""
The LibriSpeech ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/librispeech.py``; the port has no downloads).
"""
from typing import Sequence

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.librispeech import prepare_librispeech
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["librispeech"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--alignments-dir", type=click.Path(exists=True, dir_okay=True), default=None,
    help="Directory holding the optional forced alignments.")
@click.option(
    "-p", "--dataset-parts", type=str, default=["auto"], multiple=True,
    help="Which dataset parts to prepare; repeat `-p` for several.")
@click.option(
    "-j", "--num-jobs", type=int, default=1,
    help="How many threads to use (can speed up slow disks).")
@click.option(
    "--normalize-text", type=click.Choice(["none", "lower"], case_sensitive=False), default="none",
    help="Text normalization applied to the transcripts.")
def librispeech(
    corpus_dir: Pathlike, output_dir: Pathlike, alignments_dir: Pathlike,
    dataset_parts: Sequence[str], num_jobs: int, normalize_text: str):
    """(Mini) LibriSpeech ASR data preparation."""
    if len(dataset_parts) == 1:
        dataset_parts = dataset_parts[0]
    prepare_librispeech(
        corpus_dir, output_dir=output_dir, alignments_dir=alignments_dir, num_jobs=num_jobs,
        dataset_parts=dataset_parts, normalize_text=normalize_text)

