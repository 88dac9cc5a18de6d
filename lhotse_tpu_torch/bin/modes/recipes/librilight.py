"""The Libri-Light ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/speech_corpora.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.librilight import prepare_librilight
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["librilight"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def librilight(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs):
    """Libri-Light data preparation."""
    prepare_librilight(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)
