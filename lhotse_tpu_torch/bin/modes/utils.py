"""
Backend-listing commands (copied from ``lhotse_tpu/bin/modes/utils.py``).
"""
import click

from lhotse_tpu_torch.bin.modes.cli_base import cli


@cli.command()
def list_audio_backends():
    """List the names of all available audio backends."""
    from lhotse_tpu_torch.audio.backend import available_audio_backends

    click.echo(available_audio_backends())


@cli.command()
def list_io_backends():
    """List the names of all available IO backends."""
    from lhotse_tpu_torch.serialization import available_io_backends

    click.echo(available_io_backends())


@cli.command()
def list_storage_backends():
    """List all feature/array storage backends."""
    from lhotse_tpu_torch.features.io import available_storage_backends

    for backend in available_storage_backends():
        click.echo(backend)


@cli.command()
def list_resampling_backends():
    """List the names of all available resampling backends."""
    from lhotse_tpu_torch.audio.resampling_backend import available_resampling_backends

    click.echo(available_resampling_backends())
