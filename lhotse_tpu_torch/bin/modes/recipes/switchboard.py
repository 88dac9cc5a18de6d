"""The Switchboard-1 and Eval2000 ``prepare`` commands (copied from
``lhotse_tpu/bin/modes/recipes/switchboard.py``; the port has no
downloads)."""
from typing import Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.eval2000 import prepare_eval2000
from lhotse_tpu_torch.recipes.switchboard import prepare_switchboard
from lhotse_tpu_torch.utils import Pathlike

__all__ = []


@prepare.command(context_settings=dict(show_default=True))
@click.argument("audio_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--transcript-dir", "--transcripts-dir", "transcripts_dir",
    type=click.Path(exists=True), default=None)
@click.option("--sentiment-dir", type=click.Path(exists=True), default=None)
@click.option("--omit-silence/--retain-silence", default=True)
@click.option("--absolute-paths", is_flag=True, default=False)
def switchboard(
    audio_dir: Pathlike, output_dir: Pathlike, transcripts_dir: Optional[Pathlike],
    sentiment_dir: Optional[Pathlike], omit_silence: bool, absolute_paths: bool):
    """Switchboard-1 (LDC97S62) data preparation."""
    prepare_switchboard(
        audio_dir, transcripts_dir=transcripts_dir, sentiment_dir=sentiment_dir,
        output_dir=output_dir, omit_silence=omit_silence, absolute_paths=absolute_paths)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--transcript-dir", type=click.Path(exists=True, file_okay=False), default=None,
    help="Path to the LDC2002T43 transcripts if stored outside CORPUS_DIR.")
@click.option("--absolute-paths", is_flag=True, default=False)
def eval2000(
    corpus_dir: Pathlike, output_dir: Pathlike, transcript_dir, absolute_paths: bool):
    """Eval2000 / Hub5'00 (LDC2002S09 + LDC2002T43) data preparation."""
    prepare_eval2000(
        corpus_dir, output_dir=output_dir, transcript_path=transcript_dir,
        absolute_paths=absolute_paths)
