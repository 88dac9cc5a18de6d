"""The TIMIT ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/timit.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.timit import prepare_timit
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["timit"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-p", "--num-phones", type=click.Choice(["60", "48", "39"]), default="48")
@click.option("-j", "--num-jobs", type=int, default=1)
def timit(corpus_dir: Pathlike, output_dir: Pathlike, num_phones: str, num_jobs: int):
    """TIMIT data preparation (word + phone alignments)."""
    prepare_timit(corpus_dir, output_dir=output_dir, num_phones=int(num_phones), num_jobs=num_jobs)
