"""The LibriCSS ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/meetings.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.libricss import prepare_libricss
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["libricss"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--type", "mic_type", type=click.Choice(["mdm", "sdm", "ihm-mix", "ihm"]), default="mdm")
@click.option(
    "--segmented/--no-segmented", default=False,
    help="Additionally emit 1-minute segmented cuts (as in the LibriCSS paper).")
def libricss(corpus_dir: Pathlike, output_dir: Pathlike, mic_type, segmented):
    """LibriCSS data preparation."""
    prepare_libricss(corpus_dir, output_dir=output_dir, type=mic_type, segmented_cuts=segmented)
