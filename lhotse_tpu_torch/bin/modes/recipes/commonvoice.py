"""The CommonVoice ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/commonvoice.py``; the port has no downloads)."""
from typing import Sequence

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.commonvoice import (
    COMMONVOICE_DEFAULT_SPLITS, COMMONVOICE_SPLITS, prepare_commonvoice)
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["commonvoice"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-l", "--language", "languages", type=str, multiple=True, default=["auto"],
    help="Language code(s) to prepare ('auto' scans the corpus dir).")
@click.option(
    "-s", "--split", "splits", type=click.Choice(COMMONVOICE_SPLITS), multiple=True,
    default=COMMONVOICE_DEFAULT_SPLITS)
@click.option("-j", "--num-jobs", type=int, default=1)
def commonvoice(
    corpus_dir: Pathlike, output_dir: Pathlike, languages: Sequence[str], splits: Sequence[str],
    num_jobs: int):
    """CommonVoice ASR data preparation."""
    if len(languages) == 1:
        languages = languages[0]
    prepare_commonvoice(
        corpus_dir, output_dir=output_dir, languages=languages, splits=splits, num_jobs=num_jobs)

