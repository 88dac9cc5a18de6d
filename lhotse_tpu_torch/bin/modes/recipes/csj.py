"""The CSJ ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/large_corpora.py``)."""
from typing import Optional, Sequence

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes import prepare_csj
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["csj"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("manifest_dir", type=click.Path())
@click.option(
    "-t", "--transcript-dir", type=click.Path(),
    help="Directory where per-speaker transcripts are materialized.")
@click.option("-p", "--dataset-parts", type=str, multiple=True)
@click.option("-j", "--num-jobs", type=int, default=16)
def csj(
    corpus_dir: Pathlike, manifest_dir: Pathlike, transcript_dir: Optional[Pathlike],
    dataset_parts: Sequence[str], num_jobs: int):
    """CSJ (Corpus of Spontaneous Japanese) data preparation."""
    prepare_csj(
        corpus_dir=corpus_dir, transcript_dir=transcript_dir,
        manifest_dir=manifest_dir, dataset_parts=list(dataset_parts) or None,
        nj=num_jobs)
