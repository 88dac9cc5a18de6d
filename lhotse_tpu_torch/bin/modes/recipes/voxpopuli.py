"""The VoxPopuli ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/speech_corpora.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes import prepare_voxpopuli
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["voxpopuli"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--task", type=click.Choice(["asr", "s2s", "lm"]), default="asr",
    help="Which VoxPopuli task to prepare manifests for.")
@click.option("--lang", default="en")
@click.option("--src-lang", default=None, help="[s2s] Source language code.")
@click.option("--tgt-lang", default=None, help="[s2s] Target language code.")
@click.option("-j", "--num-jobs", type=int, default=1)
def voxpopuli(corpus_dir: Pathlike, output_dir: Pathlike, task, lang, src_lang, tgt_lang,
              num_jobs):
    """VoxPopuli ASR data preparation."""
    prepare_voxpopuli(
        corpus_dir, output_dir=output_dir, task=task, lang=lang, source_lang=src_lang,
        target_lang=tgt_lang, num_jobs=num_jobs)
