"""The DiPCo ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/meetings.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.dipco import prepare_dipco
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["dipco"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--mic", type=click.Choice(["ihm", "mdm"]), default="mdm")
@click.option("--normalize-text", type=click.Choice(["none", "upper", "kaldi"]), default="kaldi")
@click.option(
    "--use-chime7-offset", is_flag=True,
    help="Offset session IDs by the CHiME-7 convention (S23...).")
def dipco(corpus_dir: Pathlike, output_dir: Pathlike, mic, normalize_text, use_chime7_offset):
    """DiPCo dinner-party data preparation."""
    prepare_dipco(
        corpus_dir, output_dir=output_dir, mic=mic, normalize_text=normalize_text,
        use_chime7_offset=use_chime7_offset)
