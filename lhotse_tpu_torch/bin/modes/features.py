"""
Feature extraction commands (copied from ``lhotse_tpu/bin/modes/features.py``;
``upload`` waits for the ``lilcom_url`` storage backend).

The port's extractors run on the card unless their config asks for another
device: with no ``-f`` config the extractor is ``Fbank()`` on ``"cuda"``,
and a config with ``device: cpu`` runs the kernel's plain version on the
CPU. A card extractor on a machine without a card is refused with an error
that says so; nothing falls back to the CPU. On the card, keep ``-j 1`` for
``extract-cuts``: each worker process would start CUDA of its own.
"""
from pathlib import Path
from typing import Optional

import click
import torch

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.bin.modes.cli_base import cli
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.features import (
    Fbank, FeatureExtractor, FeatureSetBuilder, create_default_feature_extractor)
from lhotse_tpu_torch.features.base import FEATURE_EXTRACTORS
from lhotse_tpu_torch.features.io import (
    available_storage_backends, default_features_storage_backend_name, get_writer)
from lhotse_tpu_torch.utils import Pathlike, Seconds


@cli.group()
def feat():
    """Feature extraction related commands."""
    pass


# Options shared by every extraction command.
_extractor_config_opt = click.option(
    "-f", "--feature-manifest", type=click.Path(exists=True, dir_okay=False),
    help="YAML config overriding the default extractor settings.")
_storage_type_opt = click.option(
    "--storage-type", type=click.Choice(available_storage_backends()),
    default=default_features_storage_backend_name(),
    help="Backend used to store the feature matrices.")


def _load_extractor(config_path: Optional[Pathlike]) -> FeatureExtractor:
    """The configured extractor, or the default kaldi-fbank one. An
    extractor bound to a CUDA device is refused where there is no card."""
    extractor = Fbank() if config_path is None else FeatureExtractor.from_yaml(config_path)
    device = getattr(extractor.config, "device", None)
    if device is not None and torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise click.ClickException(
            f"The {extractor.name} extractor runs on a CUDA card, and this machine has none "
            "(torch.cuda.is_available() is False). To extract on the CPU, pass a config "
            "with 'device: cpu' through -f (see 'feat write-default-config').")
    return extractor


def _save_cuts(cuts: CutSet, path: Pathlike) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    cuts.to_file(path)


@feat.command(context_settings=dict(show_default=True))
@click.argument("output_config", type=click.Path())
@click.option(
    "-f", "--feature-type", type=click.Choice(list(FEATURE_EXTRACTORS)), default="kaldi-fbank",
    help="Feature extractor family to configure.")
def write_default_config(output_config: Pathlike, feature_type: str):
    """Save a default feature extraction config to OUTPUT_CONFIG."""
    create_default_feature_extractor(feature_type).to_yaml(output_config)


@feat.command(context_settings=dict(show_default=True))
@click.argument("recording_manifest", type=click.Path(exists=True, dir_okay=False))
@click.argument("output_dir", type=click.Path())
@_extractor_config_opt
@_storage_type_opt
@click.option(
    "-t", "--lilcom-tick-power", type=int, default=-5,
    help="LTC1 compression accuracy: values quantize to multiples of 2^tick_power.")
@click.option(
    "-r", "--root-dir", type=click.Path(exists=True, file_okay=False), default=None,
    help="Prefix prepended to every path in the manifest.")
@click.option("-j", "--num-jobs", type=int, default=1, help="Parallel worker processes.")
def extract(
    recording_manifest: Pathlike, output_dir: Pathlike, feature_manifest: Optional[Pathlike],
    storage_type: str, lilcom_tick_power: int, root_dir: Optional[Pathlike], num_jobs: int):
    """
    Extract features for recordings in RECORDING_MANIFEST into OUTPUT_DIR.
    """
    recordings = RecordingSet.from_file(recording_manifest)
    if root_dir is not None:
        recordings = recordings.with_path_prefix(root_dir)

    out = Path(output_dir)
    out.mkdir(exist_ok=True, parents=True)
    storage_path = out / ("feats.h5" if "hdf5" in storage_type else "storage")

    with get_writer(storage_type)(storage_path, tick_power=lilcom_tick_power) as storage:
        builder = FeatureSetBuilder(
            feature_extractor=_load_extractor(feature_manifest), storage=storage)
        builder.process_and_store_recordings(
            recordings=recordings, output_manifest=out / "feature_manifest.json.gz",
            num_jobs=num_jobs)


@feat.command(context_settings=dict(show_default=True))
@click.argument("cutset", type=click.Path(exists=True, dir_okay=False))
@click.argument("output_cutset", type=click.Path())
@click.argument("storage_path", type=click.Path())
@_extractor_config_opt
@_storage_type_opt
@click.option("-j", "--num-jobs", type=int, default=1, help="Parallel worker processes.")
def extract_cuts(
    cutset: Pathlike, output_cutset: Pathlike, storage_path: Pathlike,
    feature_manifest: Optional[Pathlike], storage_type: str, num_jobs: int):
    """
    Extract features for cuts in CUTSET into STORAGE_PATH; the updated
    manifest is written to OUTPUT_CUTSET.
    """
    cuts = CutSet.from_file(cutset).compute_and_store_features(
        extractor=_load_extractor(feature_manifest), storage_path=storage_path, num_jobs=num_jobs,
        storage_type=get_writer(storage_type))
    _save_cuts(cuts, output_cutset)


@feat.command(context_settings=dict(show_default=True))
@click.argument("cutset", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.argument("output_cutset", type=click.Path(allow_dash=True))
@click.argument("storage_path", type=click.Path())
@_extractor_config_opt
@_storage_type_opt
@click.option("-j", "--num-jobs", type=int, default=4, help="Audio read workers feeding the device.")
@click.option(
    "-b", "--batch-duration", type=float, default=600.0,
    help="Upper bound on seconds of audio per device batch.")
def extract_cuts_batch(
    cutset: Pathlike, output_cutset: Pathlike, storage_path: Pathlike,
    feature_manifest: Optional[Pathlike], storage_type: str, num_jobs: int, batch_duration: Seconds,
):
    """
    Extract features for cuts in CUTSET with batched device execution — the
    recommended high-throughput path: the fbank kernel runs once per batch
    of up to BATCH_DURATION seconds.
    """
    cuts = CutSet.from_file(cutset).compute_and_store_features_batch(
        extractor=_load_extractor(feature_manifest), storage_path=storage_path,
        batch_duration=batch_duration, num_workers=num_jobs, storage_type=get_writer(storage_type))
    _save_cuts(cuts, output_cutset)

