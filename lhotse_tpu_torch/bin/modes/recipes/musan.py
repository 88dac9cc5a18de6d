"""The MUSAN ``prepare`` command (copied from ``lhotse_tpu/bin/modes/recipes/musan.py``;
the port has no downloads)."""
from typing import Sequence

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.musan import prepare_musan
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["musan"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--parts", type=click.Choice(["music", "speech", "noise"]), multiple=True,
    default=["music", "speech", "noise"], help="Which MUSAN parts to prepare.")
@click.option(
    "--use-vocals/--no-vocals", default=True, help="Include music recordings with vocals.")
def musan(corpus_dir: Pathlike, output_dir: Pathlike, parts: Sequence[str], use_vocals: bool):
    """MUSAN data preparation (noise/music/speech for augmentation)."""
    prepare_musan(corpus_dir, output_dir=output_dir, parts=parts, use_vocals=use_vocals)
