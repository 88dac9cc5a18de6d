"""The RIRs and Noises ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/tts_and_noise.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.rir_noise import prepare_rir_noise
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["rir_noise"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--parts", type=str, multiple=True,
    default=["point_noise", "iso_noise", "real_rir", "sim_rir"],
    help="Corpus parts to prepare.")
def rir_noise(corpus_dir: Pathlike, output_dir: Pathlike, parts):
    """RIRs and Noises corpus data preparation."""
    prepare_rir_noise(corpus_dir, output_dir=output_dir, parts=list(parts))
