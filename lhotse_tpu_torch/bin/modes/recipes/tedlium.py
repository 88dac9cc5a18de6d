"""The TED-LIUM 3 ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/tedlium.py``; the port has no downloads)."""
from typing import Sequence

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.tedlium import TEDLIUM_PARTS, prepare_tedlium
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["tedlium"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("tedlium_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--parts", "--dataset-parts", "dataset_parts", type=click.Choice(TEDLIUM_PARTS),
    multiple=True, default=TEDLIUM_PARTS)
@click.option("-j", "--num-jobs", type=int, default=1)
@click.option(
    "--normalize-text", type=click.Choice(["none", "upper", "kaldi"], case_sensitive=False),
    default="none")
def tedlium(
    tedlium_dir: Pathlike, output_dir: Pathlike, dataset_parts: Sequence[str], num_jobs: int,
    normalize_text: str):
    """TED-LIUM v3 ASR data preparation."""
    prepare_tedlium(
        tedlium_dir, output_dir=output_dir, dataset_parts=dataset_parts, num_jobs=num_jobs,
        normalize_text=normalize_text)
