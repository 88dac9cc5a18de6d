"""The ``prepare`` commands of the other Chinese and Tibetan corpora (copied
from ``lhotse_tpu/bin/modes/recipes/zh_corpora_extra.py``; the port has no
downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes import (
    prepare_baker_zh, prepare_cdsd, prepare_kespeech, prepare_speechio, prepare_tal_asr,
    prepare_tal_csasr, prepare_wenetspeech4tts, prepare_xbmu_amdo31)
from lhotse_tpu_torch.utils import Pathlike

__all__ = [
    "baker_zh", "tal_asr", "tal_csasr", "cdsd", "speechio", "kespeech",
    "wenetspeech4tts", "xbmu_amdo31"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def baker_zh(corpus_dir: Pathlike, output_dir: Pathlike):
    """Baker (BZNSYP) Chinese TTS data preparation."""
    prepare_baker_zh(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def tal_asr(corpus_dir: Pathlike, output_dir: Pathlike):
    """TAL-ASR (Mandarin classroom speech) data preparation."""
    prepare_tal_asr(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1, help="Parallel metadata scan jobs.")
def tal_csasr(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs: int):
    """TAL-CSASR (Mandarin-English code-switch) data preparation."""
    prepare_tal_csasr(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def cdsd(corpus_dir: Pathlike, output_dir: Pathlike):
    """CDSD (Chinese Dysarthric Speech Database) data preparation."""
    prepare_cdsd(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def speechio(corpus_dir: Pathlike, output_dir: Pathlike):
    """SpeechIO Chinese leaderboard test-sets data preparation."""
    prepare_speechio(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--dataset-parts", type=str, multiple=True, default=["all"],
    help="Parts to prepare (e.g. train_phase1, test) or 'all'.")
@click.option("-j", "--num-jobs", type=int, default=1, help="Parallel parsing threads.")
def kespeech(corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts, num_jobs: int):
    """KeSpeech (Mandarin + subdialects) data preparation."""
    prepare_kespeech(
        corpus_dir, output_dir=output_dir, dataset_parts=list(dataset_parts),
        num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--dataset-parts", type=str, multiple=True, default=["Basic"],
    help="Quality tiers to prepare (Basic/Premium/Standard) or 'all'.")
@click.option("-j", "--num-jobs", type=int, default=1, help="Parallel scan jobs.")
def wenetspeech4tts(corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts, num_jobs: int):
    """WenetSpeech4TTS data preparation."""
    prepare_wenetspeech4tts(
        corpus_dir, dataset_parts=list(dataset_parts), output_dir=output_dir,
        num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def xbmu_amdo31(corpus_dir: Pathlike, output_dir: Pathlike):
    """XBMU-AMDO31 (Amdo Tibetan) data preparation."""
    prepare_xbmu_amdo31(corpus_dir, output_dir=output_dir)
