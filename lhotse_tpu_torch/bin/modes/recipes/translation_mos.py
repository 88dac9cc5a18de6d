"""The ``prepare`` commands of the speech-translation, MOS and large-crawl
corpora (copied from ``lhotse_tpu/bin/modes/recipes/translation_mos.py``;
the port has no downloads, and NOTSOFAR-1's command is in ``notsofar1.py``)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes import (
    prepare_bvcc, prepare_emilia, prepare_gigaspeech2, prepare_gigast, prepare_iwslt22_ta,
    prepare_mtedx, prepare_must_c)
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["mtedx", "must_c", "gigast", "iwslt22_ta", "emilia", "gigaspeech2", "bvcc"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-l", "--lang", type=str, multiple=True, default=["all"])
@click.option("-j", "--num-jobs", type=int, default=1)
def mtedx(corpus_dir: Pathlike, output_dir: Pathlike, lang, num_jobs: int):
    """Multilingual TEDx ASR data preparation."""
    prepare_mtedx(corpus_dir, output_dir, languages=list(lang), num_jobs=num_jobs)


@prepare.command(name="must-c", context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--tgt-lang", type=str, required=True, help="Target language, e.g. de, zh.")
@click.option("-j", "--num-jobs", type=int, default=1)
def must_c(corpus_dir: Pathlike, output_dir: Pathlike, tgt_lang: str, num_jobs: int):
    """MuST-C speech translation data preparation."""
    prepare_must_c(corpus_dir, output_dir, tgt_lang=tgt_lang, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("manifests_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-l", "--language", "--languages", "languages", type=str, multiple=True,
              default=["auto"])
@click.option("-p", "--subset", "--dataset-parts", "dataset_parts", type=str, multiple=True,
              default=["auto"])
def gigast(
    corpus_dir: Pathlike, manifests_dir: Pathlike, output_dir: Pathlike, languages,
    dataset_parts):
    """GigaST translated-supervisions data preparation."""
    langs = list(languages)
    parts = list(dataset_parts)
    prepare_gigast(
        corpus_dir, manifests_dir, output_dir,
        languages="auto" if langs == ["auto"] else langs,
        dataset_parts="auto" if parts == ["auto"] else parts)


@prepare.command(name="iwslt22-ta", context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("splits", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--normalize-text", is_flag=True, default=False)
@click.option(
    "--langs", type=str, default="",
    help="Comma-separated language codes for the supervision languages "
    "(e.g. 'ta,eng').")
@click.option("-j", "--num-jobs", type=int, default=1)
def iwslt22_ta(
    corpus_dir: Pathlike, splits: Pathlike, output_dir: Pathlike,
    normalize_text: bool, langs: str, num_jobs: int):
    """IWSLT-2022 Tunisian data preparation."""
    kwargs = {}
    if langs:
        kwargs["langs"] = langs.split(",")
    prepare_iwslt22_ta(
        corpus_dir, splits, output_dir=output_dir, normalize_text=normalize_text,
        num_jobs=num_jobs, **kwargs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--lang", type=str, required=True, help="One of de/en/fr/ja/ko/zh.")
@click.option("-j", "--num-jobs", type=int, default=1)
def emilia(corpus_dir: Pathlike, output_dir: Pathlike, lang: str, num_jobs: int):
    """Emilia in-the-wild speech data preparation."""
    prepare_emilia(corpus_dir, lang=lang, num_jobs=num_jobs, output_dir=output_dir)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-l", "--languages", type=str, multiple=True, default=["auto"])
@click.option("-j", "--num-jobs", type=int, default=1)
def gigaspeech2(corpus_dir: Pathlike, output_dir: Pathlike, languages, num_jobs: int):
    """GigaSpeech 2 data preparation."""
    langs = list(languages)
    prepare_gigaspeech2(
        corpus_dir, output_dir=output_dir,
        languages="auto" if langs == ["auto"] else langs, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "-nj", "--num_jobs", "--num-jobs", "num_jobs", type=int, default=1)
def bvcc(corpus_dir: Pathlike, output_dir: Pathlike, num_jobs: int):
    """BVCC / VoiceMOS data preparation."""
    prepare_bvcc(corpus_dir, output_dir=output_dir, num_jobs=num_jobs)
