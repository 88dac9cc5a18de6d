"""The VoxConverse ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/meetings.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.voxconverse import prepare_voxconverse
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["voxconverse"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--split-test", is_flag=True)
def voxconverse(corpus_dir: Pathlike, output_dir: Pathlike, split_test):
    """VoxConverse diarization data preparation."""
    prepare_voxconverse(corpus_dir, output_dir=output_dir, split_test=split_test)
