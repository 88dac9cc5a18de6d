"""The People's Speech ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/peoples_speech.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.peoples_speech import prepare_peoples_speech
from lhotse_tpu_torch.utils import Pathlike

__all__ = []


@prepare.command(name="peoples-speech", context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def peoples_speech(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs: int):
    """The People's Speech ASR data preparation."""
    prepare_peoples_speech(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)
