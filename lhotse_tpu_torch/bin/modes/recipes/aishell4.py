"""The AISHELL-4 ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/meetings.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.aishell4 import prepare_aishell4
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["aishell4"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--normalize-text", is_flag=True)
def aishell4(corpus_dir: Pathlike, output_dir: Pathlike, normalize_text):
    """AISHELL-4 meeting data preparation."""
    prepare_aishell4(corpus_dir, output_dir=output_dir, normalize_text=normalize_text)
