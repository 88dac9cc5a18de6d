"""
Supervision manipulation commands (copied from
``lhotse_tpu/bin/modes/supervision.py``).
"""
import click

from lhotse_tpu_torch.bin.modes.cli_base import cli
from lhotse_tpu_torch.serialization import load_manifest_lazy_or_eager
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


@cli.group()
def supervision():
    """Commands related to manipulating supervision manifests."""
    pass


@supervision.command()
@click.argument("in_supervision_manifest", type=click.Path(allow_dash=True))
@click.argument("out_supervision_manifest", type=click.Path(allow_dash=True))
@click.option(
    "--ctm-file", type=click.Path(exists=True, dir_okay=False),
    help="CTM file containing alignments to add.")
@click.option(
    "--alignment-type", type=str, default="word",
    help="Type of alignment to add (default = `word`).")
@click.option(
    "--match-channel/--no-match-channel", default=False,
    help="Match channel between CTM and SupervisionSegment.")
@click.option("--verbose", "-v", is_flag=True, default=False)
def with_alignment_from_ctm(
    in_supervision_manifest: Pathlike, out_supervision_manifest: Pathlike, ctm_file: Pathlike,
    alignment_type: str, match_channel: bool, verbose: bool):
    """Add alignments from a CTM file to the supervision set."""
    supervisions = load_manifest_lazy_or_eager(in_supervision_manifest)
    supervisions = supervisions.with_alignment_from_ctm(
        ctm_file=ctm_file, type=alignment_type, match_channel=match_channel, verbose=verbose)
    with SupervisionSet.open_writer(out_supervision_manifest, overwrite=True) as writer:
        if verbose:
            from tqdm import tqdm

            supervisions = tqdm(supervisions, desc="Writing supervisions")
        for s in supervisions:
            writer.write(s)
