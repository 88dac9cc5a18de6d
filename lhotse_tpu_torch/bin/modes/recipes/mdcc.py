"""The MDCC ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/speech_corpora.py``; the port has no
downloads), registered as ``MDCC``, the reference's name, and as ``mdcc``."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.mdcc import prepare_mdcc
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["mdcc"]


@prepare.command(name="MDCC", context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--dataset-parts", type=str, multiple=True, default=["all"],
    help="Parts to prepare (pass multiple -p, e.g. `-p train -p valid`).")
def mdcc(corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts):
    """MDCC (Cantonese) data preparation."""
    parts = list(dataset_parts)
    prepare_mdcc(
        corpus_dir, dataset_parts="all" if parts == ["all"] else parts,
        output_dir=output_dir)


prepare.add_command(mdcc, name="mdcc")
