"""The BUT Reverb DB ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/world_corpora.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.but_reverb_db import prepare_but_reverb_db
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["but_reverb_db"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-p", "--parts", type=str, multiple=True, default=["silence", "rir"])
def but_reverb_db(corpus_dir: Pathlike, output_dir: Pathlike, parts):
    """BUT Speech@FIT Reverb Database data preparation."""
    prepare_but_reverb_db(corpus_dir, output_dir=output_dir, parts=list(parts))
