"""The ``prepare`` commands of the simple Chinese OpenSLR corpora (copied
from ``lhotse_tpu/bin/modes/recipes/zh_corpora.py``; the port has no
downloads): ``stcmds``, ``thchs-30``, ``magicdata``, ``primewords`` and
``aidatatang-200zh``."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes import (
    prepare_aidatatang_200zh, prepare_magicdata, prepare_primewords, prepare_stcmds,
    prepare_thchs_30)
from lhotse_tpu_torch.utils import Pathlike

__all__ = []  # commands self-register on the click group


def _register(name: str, prepare_fn, help_name: str):
    @prepare.command(name=name, help=f"{help_name} ASR data preparation.",
                     context_settings=dict(show_default=True))
    @click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
    @click.argument("output_dir", type=click.Path())
    def _prepare(corpus_dir: Pathlike, output_dir: Pathlike):
        prepare_fn(corpus_dir, output_dir=output_dir)


_register("stcmds", prepare_stcmds, "ST-CMDS")
_register("thchs-30", prepare_thchs_30, "THCHS-30")
_register("magicdata", prepare_magicdata, "MagicData")
_register("primewords", prepare_primewords, "Primewords")
_register("aidatatang-200zh", prepare_aidatatang_200zh, "aidatatang_200zh")
