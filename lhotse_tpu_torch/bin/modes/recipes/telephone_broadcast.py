"""The ``prepare`` commands of the LDC telephone and broadcast corpora
CALLHOME English, CALLHOME Egyptian, Fisher Spanish, GALE Arabic, GALE
Mandarin and MGB-2 (copied from
``lhotse_tpu/bin/modes/recipes/telephone_broadcast.py``; the port has no
downloads)."""
from typing import List, Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.callhome_egyptian import prepare_callhome_egyptian
from lhotse_tpu_torch.recipes.callhome_english import prepare_callhome_english
from lhotse_tpu_torch.recipes.fisher_spanish import prepare_fisher_spanish
from lhotse_tpu_torch.recipes.gale_arabic import prepare_gale_arabic
from lhotse_tpu_torch.recipes.gale_mandarin import prepare_gale_mandarin
from lhotse_tpu_torch.recipes.mgb2 import prepare_mgb2
from lhotse_tpu_torch.utils import Pathlike

__all__ = [
    "callhome_english", "callhome_egyptian", "fisher_spanish", "gale_arabic",
    "gale_mandarin", "mgb2"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("audio-dir", type=click.Path(exists=True, file_okay=False))
@click.argument("output-dir", type=click.Path())
@click.option("--rttm-dir", type=click.Path(exists=True, file_okay=False))
@click.option(
    "--transcript-dir", type=click.Path(exists=True, file_okay=False),
    help="Provide it to prepare the ASR task (LDC97T14); omit for the SRE task.")
@click.option("--absolute-paths", type=bool, default=False)
def callhome_english(
    audio_dir: Pathlike, output_dir: Pathlike, rttm_dir: Optional[Pathlike],
    transcript_dir: Optional[Pathlike], absolute_paths: bool):
    """CALLHOME American English data preparation (ASR or SRE)."""
    prepare_callhome_english(
        audio_dir=audio_dir, rttm_dir=rttm_dir, transcript_dir=transcript_dir,
        output_dir=output_dir, absolute_paths=absolute_paths)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("audio-dir", type=click.Path(exists=True, file_okay=False))
@click.argument("transcript-dir", type=click.Path(exists=True, file_okay=False))
@click.argument("output-dir", type=click.Path())
@click.option("--absolute-paths", type=bool, default=False)
def callhome_egyptian(
    audio_dir: Pathlike, transcript_dir: Pathlike, output_dir: Pathlike,
    absolute_paths: bool):
    """CALLHOME Egyptian Arabic data preparation."""
    prepare_callhome_egyptian(
        audio_dir=audio_dir, transcript_dir=transcript_dir, output_dir=output_dir,
        absolute_paths=absolute_paths)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("audio-dir", type=click.Path(exists=True, file_okay=False))
@click.argument("transcript-dir", type=click.Path(exists=True, file_okay=False))
@click.argument("output-dir", type=click.Path())
@click.option("--absolute-paths", type=bool, default=False)
def fisher_spanish(
    audio_dir: Pathlike, transcript_dir: Pathlike, output_dir: Pathlike,
    absolute_paths: bool):
    """Fisher Spanish data preparation."""
    prepare_fisher_spanish(
        audio_dir_path=audio_dir, transcript_dir_path=transcript_dir,
        output_dir=output_dir, absolute_paths=absolute_paths)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-s", "--audio", type=click.Path(exists=True, dir_okay=True), multiple=True,
    help="Paths to audio dirs, e.g., LDC2013S02; repeat -s for multiple corpora.")
@click.option(
    "-t", "--transcript", type=click.Path(exists=True, dir_okay=True), multiple=True,
    help="Paths to transcript dirs, e.g., LDC2013T17; repeat -t for multiple corpora.")
@click.option("--absolute-paths", type=bool, default=False)
def gale_arabic(
    output_dir: Pathlike, audio: Optional[List[Pathlike]],
    transcript: Optional[List[Pathlike]], absolute_paths: bool):
    """GALE Arabic broadcast news/conversation data preparation."""
    prepare_gale_arabic(
        list(audio), list(transcript), output_dir=output_dir,
        absolute_paths=absolute_paths)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-s", "--audio", type=click.Path(exists=True, dir_okay=True), multiple=True,
    help="Paths to audio dirs, e.g., LDC2013S08; repeat -s for multiple corpora.")
@click.option(
    "-t", "--transcript", type=click.Path(exists=True, dir_okay=True), multiple=True,
    help="Paths to transcript dirs, e.g., LDC2013T20; repeat -t for multiple corpora.")
@click.option("--absolute-paths", type=bool, default=False)
@click.option(
    "--segment-words", is_flag=True, default=False,
    help="Run jieba word segmentation on the transcripts.")
def gale_mandarin(
    output_dir: Pathlike, audio: Optional[List[Pathlike]],
    transcript: Optional[List[Pathlike]], absolute_paths: bool, segment_words: bool):
    """GALE Mandarin broadcast news/conversation data preparation."""
    prepare_gale_mandarin(
        list(audio), list(transcript), output_dir=output_dir,
        absolute_paths=absolute_paths, segment_words=segment_words)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--text-cleaning/--no-text-cleaning", default=True,
    help="Basic Arabic text cleaning (punctuation/diacritics removal).")
@click.option(
    "--buck-walter/--no-buck-walter", default=False,
    help="Keep dev/test text in BuckWalter transliteration.")
@click.option("-j", "--num-jobs", type=int, default=1)
@click.option(
    "--mer-thresh", type=int, default=80,
    help="Filter out train segments with WMER above this threshold.")
def mgb2(
    corpus_dir: Pathlike, output_dir: Pathlike, text_cleaning: bool,
    buck_walter: bool, num_jobs: int, mer_thresh: int):
    """MGB-2 Arabic broadcast data preparation."""
    prepare_mgb2(
        corpus_dir, output_dir, text_cleaning=text_cleaning, buck_walter=buck_walter,
        num_jobs=num_jobs, mer_thresh=mer_thresh)

