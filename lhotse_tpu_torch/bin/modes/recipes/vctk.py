"""The VCTK ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/vctk.py``; the port has no downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.vctk import prepare_vctk
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["vctk"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("--use-edinburgh-vctk-url", is_flag=True, default=False)
@click.option("--mic-id", type=click.Choice(["mic1", "mic2"]), default="mic2")
def vctk(corpus_dir: Pathlike, output_dir: Pathlike, use_edinburgh_vctk_url: bool, mic_id: str):
    """VCTK TTS data preparation."""
    prepare_vctk(
        corpus_dir, output_dir=output_dir, use_edinburgh_vctk_url=use_edinburgh_vctk_url,
        mic_id=mic_id)
