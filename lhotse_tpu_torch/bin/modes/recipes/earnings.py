"""The Earnings-21 and Earnings-22 ``prepare`` commands (copied from
``lhotse_tpu/bin/modes/recipes/speech_corpora.py`` and ``business.py``; the
port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.earnings21 import prepare_earnings21
from lhotse_tpu_torch.recipes.earnings22 import prepare_earnings22
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["earnings21"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--normalize-text/--no-normalize-text", default=False)
def earnings21(corpus_dir: Pathlike, output_dir: Pathlike, normalize_text):
    """Earnings-21 data preparation."""
    prepare_earnings21(corpus_dir, output_dir=output_dir, normalize_text=normalize_text)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--normalize-text/--no-normalize-text", default=False)
def earnings22(corpus_dir: Pathlike, output_dir: Pathlike, normalize_text: bool):
    """Earnings-22 data preparation."""
    prepare_earnings22(corpus_dir, output_dir=output_dir, normalize_text=normalize_text)
