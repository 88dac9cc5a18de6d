"""The 1997 English Broadcast News ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/english_domain.py``)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.broadcast_news import prepare_broadcast_news
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["broadcast_news"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("audio_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("transcript_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--absolute-paths", type=bool, default=False)
def broadcast_news(
    audio_dir: Pathlike, transcript_dir: Pathlike, output_dir: Pathlike,
    absolute_paths: bool):
    """1997 English Broadcast News (HUB4) data preparation."""
    prepare_broadcast_news(
        audio_dir, transcript_dir, output_dir=output_dir, absolute_paths=absolute_paths)
