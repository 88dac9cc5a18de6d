"""The AMI ``prepare`` command (copied from ``lhotse_tpu/bin/modes/recipes/ami.py``;
the port has no downloads)."""
from typing import Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.ami import MICS, PARTITIONS, prepare_ami
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["ami"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--annotations", "--annotations-dir", "annotations_dir", type=click.Path(exists=True),
    default=None,
    help="Provide if annotations were downloaded to a different directory than the corpus.")
@click.option("--mic", type=click.Choice(MICS), default="ihm")
@click.option("--partition", type=click.Choice(sorted(PARTITIONS)), default="full-corpus-asr")
@click.option(
    "--normalize-text", type=click.Choice(["none", "upper", "kaldi"], case_sensitive=False),
    default="kaldi")
@click.option("--max-words-per-segment", type=int, default=None)
@click.option("--merge-consecutive/--no-merge-consecutive", default=False)
@click.option("--keep-punctuation/--no-keep-punctuation", default=False)
def ami(
    corpus_dir: Pathlike, output_dir: Pathlike, annotations_dir: Optional[Pathlike], mic: str,
    partition: str, normalize_text: str, max_words_per_segment: Optional[int],
    merge_consecutive: bool, keep_punctuation: bool):
    """AMI Meeting Corpus data preparation."""
    prepare_ami(
        corpus_dir, annotations_dir=annotations_dir, output_dir=output_dir, mic=mic,
        partition=partition, normalize_text=normalize_text,
        max_words_per_segment=max_words_per_segment, merge_consecutive=merge_consecutive,
        keep_punctuation=keep_punctuation)

