"""The LJ Speech ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/ljspeech.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.ljspeech import prepare_ljspeech
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["ljspeech"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def ljspeech(corpus_dir: Pathlike, output_dir: Pathlike):
    """LJSpeech TTS data preparation."""
    prepare_ljspeech(corpus_dir, output_dir=output_dir)
