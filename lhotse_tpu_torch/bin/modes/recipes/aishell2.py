"""The AISHELL-2 ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/speech_corpora.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.aishell2 import prepare_aishell2
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["aishell2"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def aishell2(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs: int):
    """AISHELL-2 data preparation."""
    prepare_aishell2(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)
