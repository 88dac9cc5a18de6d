"""The NOTSOFAR-1 ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/translation_mos.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.notsofar1 import prepare_notsofar1
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["notsofar1"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def notsofar1(corpus_dir: Pathlike, output_dir: Pathlike):
    """NOTSOFAR-1 meeting benchmark data preparation."""
    prepare_notsofar1(corpus_dir, output_dir=output_dir)
