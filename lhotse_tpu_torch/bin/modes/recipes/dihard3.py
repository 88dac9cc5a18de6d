"""The DIHARD III ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/meetings.py``)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.dihard3 import prepare_dihard3
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["dihard3"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--dev", "--dev-audio-dir", "dev_audio_dir", type=click.Path(exists=True), default=None)
@click.option(
    "--eval", "--eval-audio-dir", "eval_audio_dir", type=click.Path(exists=True), default=None)
@click.option(
    "--uem/--no-uem", default=True, help="Whether to create UEM supervisions.")
@click.option(
    "-j", "--num-jobs", type=int, default=1,
    help="Parallel jobs scanning the corpus directories for recordings.")
def dihard3(output_dir: Pathlike, dev_audio_dir, eval_audio_dir, uem, num_jobs):
    """DIHARD III data preparation."""
    prepare_dihard3(
        dev_audio_dir=dev_audio_dir, eval_audio_dir=eval_audio_dir, output_dir=output_dir,
        uem_manifest=uem, num_jobs=num_jobs)
