"""
CLI entry group (copied from ``lhotse_tpu/bin/modes/cli_base.py``).
"""
import logging

import click


@click.group()
@click.version_option(package_name="lhotse-tpu", prog_name="lhotse-tpu-torch")
@click.option("-s", "--seed", type=int, help="Random seed.")
def cli(seed):
    """
    The shell entry point to lhotse-tpu-torch, the PyTorch/CUDA port of
    lhotse-tpu, a tool and library for audio data manipulation.
    """
    logging.basicConfig(
        format="%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s",
        level=logging.INFO)
    if seed is not None:
        from lhotse_tpu_torch.utils import fix_random_seed

        fix_random_seed(seed)


@cli.group()
def prepare():
    """Command group with data preparation recipes."""
    pass


@cli.group()
def download():
    """Command group for download and extract data."""
    pass
