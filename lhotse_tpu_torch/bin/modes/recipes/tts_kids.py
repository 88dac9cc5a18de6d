"""The ``prepare`` commands of the TTS, accented-speech and children's
corpora (copied from ``lhotse_tpu/bin/modes/recipes/tts_and_noise.py``,
``libri_variants.py``, ``speech_corpora.py``, ``english_domain.py`` and
``world_corpora.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes import (
    prepare_adept, prepare_cmu_arctic, prepare_cmu_indic, prepare_cmu_kids, prepare_cslu_kids,
    prepare_daily_talk, prepare_ears, prepare_grid, prepare_hifitts, prepare_l2_arctic,
    prepare_oto_speech)
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["adept", "cmu_arctic", "cmu_indic", "cmu_kids", "cslu_kids", "daily_talk", "ears",
           "grid", "hifitts", "l2_arctic", "oto_speech"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def cmu_arctic(corpus_dir: Pathlike, output_dir: Pathlike):
    """CMU ARCTIC data preparation."""
    prepare_cmu_arctic(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def l2_arctic(corpus_dir: Pathlike, output_dir: Pathlike):
    """L2-ARCTIC data preparation."""
    prepare_l2_arctic(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def hifitts(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs):
    """Hi-Fi TTS data preparation."""
    prepare_hifitts(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def adept(corpus_dir: Pathlike, output_dir: Pathlike):
    """ADEPT prosody corpus data preparation."""
    prepare_adept(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def daily_talk(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs: int):
    """DailyTalk data preparation."""
    prepare_daily_talk(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def ears(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs: int):
    """EARS data preparation."""
    prepare_ears(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
def cmu_indic(corpus_dir: Pathlike, output_dir: Pathlike):
    """CMU Indic TTS databases data preparation."""
    prepare_cmu_indic(corpus_dir, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--absolute-paths", type=bool, default=True)
@click.option("--normalize-text/--no-normalize-text", default=True)
def cslu_kids(
    corpus_dir: Pathlike, output_dir: Pathlike, absolute_paths: bool,
    normalize_text: bool):
    """CSLU Kids (LDC2007S18) data preparation."""
    prepare_cslu_kids(
        corpus_dir, output_dir=output_dir, absolute_paths=absolute_paths,
        normalize_text=normalize_text)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--absolute-paths", type=bool, default=True,
    help="Use absolute audio paths in the manifests.")
def cmu_kids(corpus_dir: Pathlike, output_dir: Pathlike, absolute_paths: bool):
    """CMU Kids data preparation."""
    prepare_cmu_kids(corpus_dir, output_dir=output_dir, absolute_paths=absolute_paths)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--with-supervisions/--no-supervisions", default=True)
@click.option("-j", "--jobs", "--num-jobs", "num_jobs", type=int, default=1)
def grid(corpus_dir: Pathlike, output_dir: Pathlike, with_supervisions: bool, num_jobs: int):
    """Grid audiovisual corpus data preparation."""
    prepare_grid(
        corpus_dir, output_dir=output_dir, with_supervisions=with_supervisions,
        num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--dataset-parts", type=str, multiple=True, default=("train",),
    help="Dataset parts to prepare.")
@click.option("--target-sr", type=int, default=16000)
def oto_speech(corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts, target_sr: int):
    """otoSpeech full-duplex conversations data preparation."""
    prepare_oto_speech(corpus_dir, output_dir, parts=dataset_parts, target_sr=target_sr)
