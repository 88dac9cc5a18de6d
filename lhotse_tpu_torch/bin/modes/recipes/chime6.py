"""The CHiME-6 ``prepare`` command (copied from
``lhotse_tpu/bin/modes/recipes/meetings.py``; the port has no downloads).
``--perform-array-sync`` reads the edits from
``OUTPUT_DIR/CHiME6/audio_edits.json``; ``--verify-md5-checksums`` stops
with ``NotImplementedError``, since the checksum list is downloaded."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.recipes.chime6 import prepare_chime6
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["chime6"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-p", "--dataset-parts", type=str, default=["all"], multiple=True,
    help="Parts to prepare (pass multiple -p; default: all).")
@click.option("--mic", type=click.Choice(["ihm", "mdm"]), default="mdm")
@click.option(
    "--use-reference-array", is_flag=True,
    help="In mdm dev/eval, restrict each supervision's channels to its "
    "annotated reference array.")
@click.option(
    "--perform-array-sync", is_flag=True,
    help="Run array synchronization over a raw CHiME-5 corpus first "
    "(writes the synchronized corpus to OUTPUT_DIR/CHiME6; the edits are read from "
    "OUTPUT_DIR/CHiME6/audio_edits.json).")
@click.option(
    "--verify-md5-checksums", is_flag=True,
    help="Verify audio MD5 checksums against the official post-sync list (which is "
    "downloaded: not ported, raises).")
@click.option("-j", "--num-jobs", type=int, default=1, help="Parallel array-sync jobs.")
@click.option(
    "-t", "--num-threads-per-job", type=int, default=1,
    help="Threads per job for clock-drift correction.")
@click.option(
    "--sox-path", type=click.Path(), default="/usr/bin/sox",
    help="Path to the sox v14.4.2 binary (bit-exact clock-drift warps).")
@click.option("--normalize-text", type=click.Choice(["none", "upper", "kaldi"]), default="kaldi")
@click.option("--use-chime7-split", is_flag=True)
def chime6(
    corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts, mic, use_reference_array,
    perform_array_sync, verify_md5_checksums, num_jobs, num_threads_per_job, sox_path,
    normalize_text, use_chime7_split):
    """CHiME-6 dinner-party data preparation (array-synchronized corpus)."""
    prepare_chime6(
        corpus_dir, output_dir=output_dir, dataset_parts=list(dataset_parts), mic=mic,
        use_reference_array=use_reference_array, perform_array_sync=perform_array_sync,
        verify_md5_checksums=verify_md5_checksums, num_jobs=num_jobs,
        num_threads_per_job=num_threads_per_job, sox_path=sox_path,
        normalize_text=normalize_text, use_chime7_split=use_chime7_split)
