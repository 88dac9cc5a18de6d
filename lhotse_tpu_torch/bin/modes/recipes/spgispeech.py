"""The SPGISpeech ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/business.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.spgispeech import prepare_spgispeech
from lhotse_tpu_torch.utils import Pathlike

__all__ = []


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--normalize-text/--no-normalize-text", default=True)
@click.option("-j", "--num-jobs", type=int, default=1)
def spgispeech(corpus_dir: Pathlike, output_dir: Pathlike, normalize_text: bool, num_jobs: int):
    """SPGISpeech data preparation."""
    prepare_spgispeech(
        corpus_dir, output_dir=output_dir, normalize_text=normalize_text, num_jobs=num_jobs)
