"""The AISHELL-3 ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/speech_corpora.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.aishell3 import prepare_aishell3
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["aishell3"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def aishell3(corpus_dir: Pathlike, output_dir: Pathlike):
    """AISHELL-3 TTS data preparation."""
    prepare_aishell3(corpus_dir, output_dir=output_dir)
