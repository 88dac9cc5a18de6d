"""The ICSI ``prepare`` command (copied from ``lhotse_tpu/bin/modes/recipes/icsi.py``;
the port has no downloads)."""
from typing import Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.icsi import MIC_TO_CHANNELS, prepare_icsi
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["icsi"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("audio_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--transcripts-dir", type=click.Path(exists=True), default=None)
@click.option("--mic", type=click.Choice(sorted(MIC_TO_CHANNELS)), default="ihm")
@click.option(
    "--normalize-text", type=click.Choice(["none", "upper", "kaldi"], case_sensitive=False),
    default="kaldi")
@click.option(
    "--save-to-wav", is_flag=True, default=False,
    help="For sdm/ihm/mdm, decode the .sph channels once and store WAVs "
    "under OUTPUT_DIR/wavs for faster reads.")
def icsi(
    audio_dir: Pathlike, output_dir: Pathlike, transcripts_dir: Optional[Pathlike], mic: str,
    normalize_text: str, save_to_wav: bool):
    """ICSI Meeting Corpus data preparation."""
    prepare_icsi(
        audio_dir, transcripts_dir=transcripts_dir, output_dir=output_dir, mic=mic,
        normalize_text=normalize_text, save_to_wav=save_to_wav)
