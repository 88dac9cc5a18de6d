"""The VoxCeleb ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/voxceleb.py``; the port has no downloads)."""
from typing import Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.voxceleb import prepare_voxceleb
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["voxceleb"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "--voxceleb1", "--v1", "voxceleb1_root", type=click.Path(exists=True), default=None,
    help="Path to the VoxCeleb1 corpus root.")
@click.option(
    "--voxceleb2", "--v2", "voxceleb2_root", type=click.Path(exists=True), default=None,
    help="Path to the VoxCeleb2 corpus root.")
@click.option(
    "--trials-path", type=click.Path(exists=True, dir_okay=False), default=None,
    help="Local copy of the VoxCeleb1 trials list (voxceleb1_test_v2.txt); "
         "when provided, pos/neg trial CutSet pairs are prepared as well.")
@click.option("-j", "--num-jobs", type=int, default=1)
def voxceleb(
    output_dir: Pathlike, voxceleb1_root: Optional[Pathlike], voxceleb2_root: Optional[Pathlike],
    trials_path: Optional[Pathlike], num_jobs: int):
    """VoxCeleb 1+2 speaker verification data preparation."""
    prepare_voxceleb(
        voxceleb1_root=voxceleb1_root, voxceleb2_root=voxceleb2_root, output_dir=output_dir,
        num_jobs=num_jobs, trials_path=trials_path)
