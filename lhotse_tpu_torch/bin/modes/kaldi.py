"""
Kaldi interop commands (copied from ``lhotse_tpu/bin/modes/kaldi.py``).
"""
from pathlib import Path
from typing import Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import cli
from lhotse_tpu_torch.utils import Pathlike


@cli.group()
def kaldi():
    """Kaldi data directory format import/export."""
    pass


@kaldi.command(name="import", context_settings=dict(show_default=True))
@click.argument("data_dir", type=click.Path(exists=True, file_okay=False))
@click.argument("sampling_rate", type=int)
@click.argument("manifest_dir", type=click.Path())
@click.option(
    "-f", "--frame-shift", type=float, help="Frame shift (seconds) — required to import feats.scp.")
@click.option(
    "-u", "--map-string-to-underscores", type=str, default=None,
    help="Replace this string with underscores in segment/speaker IDs.")
@click.option(
    "--use-reco2dur/--no-use-reco2dur", default=True,
    help="Read durations from reco2dur when available instead of the audio.")
@click.option(
    "-d", "--compute-durations", is_flag=True, default=False,
    help="Compute durations by reading the audio instead of the reco2dur "
    "file (alias of --no-use-reco2dur).")
@click.option("-j", "--num-jobs", type=int, default=1, help="Parallel duration reads.")
@click.option(
    "-t", "--feature-type", type=click.Choice(["kaldi-fbank", "kaldi-mfcc"]),
    default="kaldi-fbank",
    help="Feature type when importing precomputed features from feats.scp.")
def import_(
    data_dir: Pathlike, sampling_rate: int, manifest_dir: Pathlike, frame_shift: Optional[float],
    map_string_to_underscores: Optional[str], use_reco2dur: bool, compute_durations: bool,
    num_jobs: int, feature_type: str):
    """
    Convert a Kaldi DATA_DIR (wav.scp + optional segments/text/utt2spk/...)
    into recordings/supervisions[/features] manifests in MANIFEST_DIR.
    """
    from lhotse_tpu_torch.kaldi import load_kaldi_data_dir

    recording_set, supervision_set, feature_set = load_kaldi_data_dir(
        path=data_dir, sampling_rate=sampling_rate, frame_shift=frame_shift,
        map_string_to_underscores=map_string_to_underscores,
        use_reco2dur=use_reco2dur and not compute_durations,
        num_jobs=num_jobs, feature_type=feature_type)
    manifest_dir = Path(manifest_dir)
    manifest_dir.mkdir(parents=True, exist_ok=True)
    recording_set.to_file(manifest_dir / "recordings.jsonl.gz")
    if supervision_set is not None:
        supervision_set.to_file(manifest_dir / "supervisions.jsonl.gz")
    if feature_set is not None:
        feature_set.to_file(manifest_dir / "features.jsonl.gz")


@kaldi.command(context_settings=dict(show_default=True))
@click.argument("recordings", type=click.Path(exists=True, dir_okay=False))
@click.argument("supervisions", type=click.Path(exists=True, dir_okay=False))
@click.argument("output_dir", type=click.Path())
@click.option(
    "-u", "--map-underscores-to", type=str, default=None,
    help="Replace underscores with this string in segment/speaker IDs.")
@click.option(
    "-p", "--prefix-spk-id", is_flag=True, default=False,
    help="Prefix utterance IDs with the speaker ID (required Kaldi sorting).")
def export(
    recordings: Pathlike, supervisions: Pathlike, output_dir: Pathlike,
    map_underscores_to: Optional[str], prefix_spk_id: bool):
    """
    Export RECORDINGS and SUPERVISIONS manifests to a Kaldi data directory.
    """
    from lhotse_tpu_torch.serialization import load_manifest
    from lhotse_tpu_torch.kaldi import export_to_kaldi

    export_to_kaldi(
        recordings=load_manifest(recordings), supervisions=load_manifest(supervisions),
        output_dir=output_dir, map_underscores_to=map_underscores_to, prefix_spk_id=prefix_spk_id)
