"""The ``prepare`` commands of the large ASR training corpora (copied from
``lhotse_tpu/bin/modes/recipes/world_corpora.py``, ``large_corpora.py`` and
``speech_corpora.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes import (
    prepare_bengaliai_speech, prepare_heroico, prepare_icmcasr, prepare_ksponspeech,
    prepare_nsc, prepare_reazonspeech, prepare_single_babel_language)
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["babel", "bengaliai_speech", "heroico", "icmcasr", "ksponspeech", "nsc",
           "reazonspeech"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def babel(corpus_dir: Pathlike, output_dir: Pathlike):
    """IARPA BABEL data preparation (single language package)."""
    prepare_single_babel_language(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def bengaliai_speech(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs: int):
    """Bengali.AI Speech data preparation."""
    prepare_bengaliai_speech(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("speech_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("transcript_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def heroico(speech_dir: Pathlike, transcript_dir: Pathlike, output_dir: Pathlike):
    """Heroico+USMA Spanish data preparation."""
    prepare_heroico(speech_dir, transcript_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--mic", type=click.Choice(["ihm", "sdm", "mdm"]), default="ihm")
@click.option("-j", "--num-jobs", type=int, default=1)
def icmcasr(corpus_dir: Pathlike, output_dir: Pathlike, mic: str, num_jobs: int):
    """ICMC-ASR in-car Mandarin data preparation."""
    prepare_icmcasr(corpus_dir, output_dir=output_dir, mic=mic, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-p", "--dataset-parts", type=str, multiple=True, default=["all"])
@click.option("-j", "--num-jobs", type=int, default=1)
@click.option("--normalize-text", type=click.Choice(["default", "none"]), default="default")
def ksponspeech(
    corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts, num_jobs: int,
    normalize_text: str):
    """KsponSpeech (Korean) data preparation."""
    parts = list(dataset_parts)
    prepare_ksponspeech(
        corpus_dir, dataset_parts="all" if parts == ["all"] else parts,
        output_dir=output_dir, num_jobs=num_jobs, normalize_text=normalize_text)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--dataset-part", type=str, default="PART3_SameCloseMic",
    help="Which part of NSC to prepare, e.g. PART3_SameCloseMic.")
@click.option("-j", "--num-jobs", type=int, default=1)
def nsc(corpus_dir: Pathlike, output_dir: Pathlike, dataset_part: str, num_jobs: int):
    """NSC (National Speech Corpus of Singapore English) data preparation."""
    prepare_nsc(
        corpus_dir, dataset_part=dataset_part, output_dir=output_dir,
        num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def reazonspeech(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs: int):
    """ReazonSpeech (Japanese) data preparation."""
    prepare_reazonspeech(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)
