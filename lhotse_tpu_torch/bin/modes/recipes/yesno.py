"""The YesNo ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/yesno.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.yesno import prepare_yesno
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["yesno"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def yesno(corpus_dir: Pathlike, output_dir: Pathlike):
    """YesNo ASR data preparation."""
    prepare_yesno(corpus_dir, output_dir=output_dir)
