"""The WHAM! ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/tts_and_noise.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.wham import prepare_wham
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["wham"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def wham(corpus_dir: Pathlike, output_dir: Pathlike):
    """WHAM! noise data preparation."""
    prepare_wham(corpus_dir, output_dir=output_dir)
