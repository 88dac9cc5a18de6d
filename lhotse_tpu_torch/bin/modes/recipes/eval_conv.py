"""The ``prepare`` commands of WenetSpeech, GigaSpeech, UWB-ATCC, This
American Life and SBCSAE (copied from ``lhotse_tpu/bin/modes/recipes/``
``wenet_speech.py``, ``gigaspeech.py``, ``english_domain.py`` and
``large_corpora.py``; the port has no downloads)."""
from typing import Sequence

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes import (
    prepare_gigaspeech, prepare_sbcsae, prepare_this_american_life, prepare_uwb_atcc,
    prepare_wenet_speech)
from lhotse_tpu_torch.recipes.gigaspeech import GIGASPEECH_PARTS
from lhotse_tpu_torch.recipes.wenet_speech import WENET_SPEECH_PARTS
from lhotse_tpu_torch.utils import Pathlike

# ``wenet_speech`` is registered but not exported, as in the JAX package.
__all__ = ["gigaspeech", "sbcsae", "this_american_life", "uwb_atcc"]


@prepare.command(name="wenet-speech", context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--dataset-parts", type=click.Choice(("all",) + WENET_SPEECH_PARTS), multiple=True,
    default=["all"])
@click.option("-j", "--num-jobs", type=int, default=1)
def wenet_speech(
        corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts: Sequence[str], num_jobs: int):
    """WenetSpeech ASR data preparation."""
    prepare_wenet_speech(
        corpus_dir, dataset_parts=list(dataset_parts), output_dir=output_dir, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--subset", "--dataset-parts", "dataset_parts",
    type=click.Choice(("auto",) + GIGASPEECH_PARTS), multiple=True, default=["auto"])
@click.option("-j", "--num-jobs", type=int, default=1)
def gigaspeech(
        corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts: Sequence[str], num_jobs: int):
    """GigaSpeech ASR data preparation (requires 'speechcolab')."""
    if len(dataset_parts) == 1:
        dataset_parts = dataset_parts[0]
    prepare_gigaspeech(
        corpus_dir, output_dir=output_dir, dataset_parts=dataset_parts, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def this_american_life(corpus_dir: Pathlike, output_dir: Pathlike):
    """This American Life podcast data preparation."""
    prepare_this_american_life(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--silence-sym", type=str, default="")
@click.option("--breath-sym", type=str, default="")
@click.option("--noise-sym", type=str, default="")
@click.option("--foreign-sym", type=str, default="<unk>")
@click.option("--partial-sym", type=str, default="<unk>")
@click.option("--unintelligble-sym", type=str, default="<unk>")
@click.option("--unknown-sym", type=str, default="<unk>")
def uwb_atcc(
        corpus_dir: Pathlike, output_dir: Pathlike, silence_sym: str, breath_sym: str,
        noise_sym: str, foreign_sym: str, partial_sym: str, unintelligble_sym: str,
        unknown_sym: str):
    """UWB-ATCC air traffic control data preparation."""
    prepare_uwb_atcc(
        corpus_dir, output_dir=output_dir, silence_sym=silence_sym, breath_sym=breath_sym,
        noise_sym=noise_sym, foreign_sym=foreign_sym, partial_sym=partial_sym,
        unintelligble_sym=unintelligble_sym, unknown_sym=unknown_sym)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--geolocation", is_flag=True, default=False,
    help="Attach speaker hometown coordinates (needs the network: not supported).")
@click.option(
    "--omit-realignments", is_flag=True, default=False,
    help="Only output the original corpus segmentation (the realignments need the network).")
def sbcsae(corpus_dir: Pathlike, output_dir: Pathlike, geolocation: bool,
           omit_realignments: bool):
    """SBCSAE (Santa Barbara Corpus) data preparation."""
    prepare_sbcsae(corpus_dir, output_dir=output_dir, geolocation=geolocation,
                   omit_realignments=omit_realignments)
