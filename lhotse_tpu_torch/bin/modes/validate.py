"""
Validation commands (copied from ``lhotse_tpu/bin/modes/validate.py``).
"""
from pathlib import Path

import click

from lhotse_tpu_torch.bin.modes.cli_base import cli
from lhotse_tpu_torch.utils import Pathlike


@cli.command(name="validate")
@click.argument("manifest", type=click.Path(exists=True, dir_okay=False))
@click.option(
    "--read-data/--dont-read-data", default=False,
    help="Read the audio/features data from disk for additional checks " "(can be very slow for large manifests).",
)
def validate_(manifest: Pathlike, read_data: bool):
    """Validate a manifest file."""
    from lhotse_tpu_torch.qa import validate
    from lhotse_tpu_torch.serialization import load_manifest

    data = load_manifest(manifest)
    try:
        validate(data, read_data=read_data)
    except AssertionError as e:
        click.echo(f"Validation failed: {e}")
        return 1


@cli.command(name="validate-pair")
@click.argument("recordings", type=click.Path(exists=True, dir_okay=False))
@click.argument("supervisions", type=click.Path(exists=True, dir_okay=False))
@click.option(
    "--read-data/--dont-read-data", default=False,
    help="Read the audio/features data from disk for additional checks.")
def validate_pair_(recordings: Pathlike, supervisions: Pathlike, read_data: bool):
    """Validate that RECORDINGS and SUPERVISIONS manifests are consistent."""
    from lhotse_tpu_torch.qa import validate_recordings_and_supervisions
    from lhotse_tpu_torch.serialization import load_manifest

    recs = load_manifest(recordings)
    sups = load_manifest(supervisions)
    try:
        validate_recordings_and_supervisions(
            recordings=recs, supervisions=sups, read_data=read_data)
    except AssertionError as e:
        click.echo(f"Validation failed: {e}")
        return 1


@cli.command(name="fix")
@click.argument("recordings", type=click.Path(exists=True, dir_okay=False))
@click.argument("supervisions", type=click.Path(exists=True, dir_okay=False))
@click.argument("output_dir", type=click.Path())
def fix_(recordings: Pathlike, supervisions: Pathlike, output_dir: Pathlike):
    """
    Fix a RECORDINGS + SUPERVISIONS pair: drop unmatched items, trim
    supervisions that exceed recordings, etc. Writes to OUTPUT_DIR under
    the same filenames.
    """
    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.qa import fix_manifests
    from lhotse_tpu_torch.supervision import SupervisionSet

    output_dir = Path(output_dir)
    recordings = Path(recordings)
    supervisions = Path(supervisions)
    output_dir.mkdir(parents=True, exist_ok=True)
    recs = RecordingSet.from_file(recordings)
    sups = SupervisionSet.from_file(supervisions)
    recs, sups = fix_manifests(recordings=recs, supervisions=sups)
    recs.to_file(output_dir / recordings.name)
    sups.to_file(output_dir / supervisions.name)


@cli.command(name="validate-shar")
@click.argument("in_dir", type=click.Path(exists=True, file_okay=False))
@click.option(
    "--read-data/--dont-read-data", default=False,
    help="Additionally decode every cut's payloads (slow on large archives).")
def validate_shar_(in_dir: Pathlike, read_data: bool):
    """Check the integrity of a Shar directory: shard counts, cut/tar id
    alignment, index sidecar consistency, optional payload decoding."""
    from lhotse_tpu_torch.qa import validate_shar

    try:
        validate_shar(in_dir, read_data=read_data)
    except AssertionError as e:
        click.echo(f"Validation failed: {e}")
        return 1
    click.echo("OK")
