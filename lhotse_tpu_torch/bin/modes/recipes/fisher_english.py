"""The Fisher English ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/speech_corpora.py``)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.fisher_english import prepare_fisher_english
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["fisher_english"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-a", "--audio-dirs", type=str, multiple=True, default=["LDC2004S13", "LDC2005S13"],
    help="Audio corpus directory names under CORPUS_DIR.")
@click.option(
    "-t", "--transcript-dirs", type=str, multiple=True, default=["LDC2004T19", "LDC2005T19"],
    help="Transcript corpus directory names under CORPUS_DIR.")
@click.option("--absolute-paths", type=bool, default=False)
@click.option("-j", "--num-jobs", type=int, default=1)
def fisher_english(
    corpus_dir: Pathlike, output_dir: Pathlike, audio_dirs, transcript_dirs,
    absolute_paths: bool, num_jobs):
    """Fisher English Parts 1+2 data preparation."""
    prepare_fisher_english(
        corpus_dir, output_dir=output_dir, audio_dirs=list(audio_dirs),
        transcript_dirs=list(transcript_dirs), absolute_paths=absolute_paths,
        num_jobs=num_jobs)
