"""The TED-LIUM 2 ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/speech_corpora.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.tedlium2 import prepare_tedlium2
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["tedlium2"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("tedlium_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--parts", "--dataset-parts", "dataset_parts",
    type=click.Choice(["train", "dev", "test"]), multiple=True,
    default=["train", "dev", "test"])
@click.option("--normalize-text", type=click.Choice(["none", "upper", "kaldi"]), default="none")
@click.option("-j", "--num-jobs", type=int, default=1)
def tedlium2(tedlium_dir: Pathlike, output_dir: Pathlike, dataset_parts, normalize_text, num_jobs):
    """TED-LIUM v2 data preparation."""
    prepare_tedlium2(
        tedlium_dir, output_dir=output_dir, dataset_parts=list(dataset_parts),
        normalize_text=normalize_text, num_jobs=num_jobs)
