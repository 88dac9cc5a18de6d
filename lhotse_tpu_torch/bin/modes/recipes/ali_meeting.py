"""The AliMeeting ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/meetings.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.ali_meeting import prepare_ali_meeting
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["ali_meeting"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--mic", type=click.Choice(["near", "far", "ihm", "sdm", "mdm"]), default="far")
@click.option("--normalize-text", type=click.Choice(["none", "m2met"]), default="none")
@click.option(
    "--save-mono", is_flag=True,
    help="For the sdm mic, extract and save the first channel as mono "
    "recordings under OUTPUT_DIR with sox (speeds up downstream reads).")
def ali_meeting(corpus_dir: Pathlike, output_dir: Pathlike, mic, normalize_text, save_mono):
    """AliMeeting data preparation."""
    prepare_ali_meeting(
        corpus_dir, output_dir=output_dir, mic=mic, normalize_text=normalize_text,
        save_mono=save_mono)
