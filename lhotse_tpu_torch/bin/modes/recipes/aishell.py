"""The AISHELL-1 ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/aishell.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.aishell import prepare_aishell
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["aishell"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def aishell(corpus_dir: Pathlike, output_dir: Pathlike):
    """AISHELL-1 ASR data preparation."""
    prepare_aishell(corpus_dir, output_dir=output_dir)
