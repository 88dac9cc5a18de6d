"""The LibriTTS and LibriTTS-R ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/libritts.py``; the port has no downloads)."""
from typing import Sequence

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.libritts import prepare_libritts
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["libritts", "librittsr"]


def _prepare_opts(fn):
    fn = click.option(
        "-p", "--dataset-parts", type=str, default=["all"], multiple=True,
        help="Dataset parts to prepare (e.g. dev-clean).")(fn)
    fn = click.option("-j", "--num-jobs", type=int, default=1)(fn)
    fn = click.option(
        "--link-previous-utterance/--no-previous-utterance",
        "--link-previous-utt/--no-link-previous-utt", "link_previous_utt", default=False,
        help="Attach the previous utterance id to supervisions (for TTS chains).")(fn)
    return fn


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@_prepare_opts
def libritts(
    corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts: Sequence[str], num_jobs: int,
    link_previous_utt: bool):
    """LibriTTS TTS data preparation."""
    if len(dataset_parts) == 1:
        dataset_parts = dataset_parts[0]
    prepare_libritts(
        corpus_dir, output_dir=output_dir, dataset_parts=dataset_parts, num_jobs=num_jobs,
        link_previous_utt=link_previous_utt)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@_prepare_opts
def librittsr(
    corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts: Sequence[str], num_jobs: int,
    link_previous_utt: bool):
    """LibriTTS-R TTS data preparation."""
    if len(dataset_parts) == 1:
        dataset_parts = dataset_parts[0]
    prepare_libritts(
        corpus_dir, output_dir=output_dir, dataset_parts=dataset_parts, num_jobs=num_jobs,
        link_previous_utt=link_previous_utt)
