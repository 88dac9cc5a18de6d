"""The Multilingual LibriSpeech (MLS) ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/mls.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.mls import prepare_mls
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["mls"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--opus/--flac", default=True, help="Scan for OPUS (default) or FLAC audio files.")
@click.option("-j", "--num-jobs", type=int, default=1)
def mls(corpus_dir: Pathlike, output_dir: Pathlike, opus: bool, num_jobs: int):
    """Multilingual LibriSpeech (MLS) data preparation."""
    prepare_mls(corpus_dir, output_dir=output_dir, opus=opus, num_jobs=num_jobs)
