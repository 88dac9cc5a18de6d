"""
CutSet creation and manipulation commands (copied from
``lhotse_tpu/bin/modes/cut.py``).
"""
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import cli
from lhotse_tpu_torch.cut import CutSet, append_cuts, mix_cuts
from lhotse_tpu_torch.serialization import load_manifest_lazy_or_eager
from lhotse_tpu_torch.utils import Pathlike


def _stream_out(cuts, path: Pathlike) -> None:
    """Write a cut iterable to a manifest without materializing it."""
    with CutSet.open_writer(path) as writer:
        for c in cuts:
            writer.write(c)


@cli.group()
def cut():
    """Group of commands used to create CutSets."""
    pass


@cut.command()
@click.argument("output_cut_manifest", type=click.Path(allow_dash=True))
@click.option(
    "-r", "--recording-manifest", type=click.Path(exists=True, dir_okay=False),
    help="Recording manifest whose entries the cuts will reference.")
@click.option(
    "-f", "--feature-manifest", type=click.Path(exists=True, dir_okay=False),
    help="Feature manifest whose entries the cuts will reference.")
@click.option(
    "-s", "--supervision-manifest", type=click.Path(exists=True, dir_okay=False),
    help="Supervision manifest whose entries the cuts will reference.")
@click.option(
    "--force-eager", is_flag=True,
    help="Read full manifests into memory first (required when the inputs " "are not sorted by recording ID).",
)
def simple(
    output_cut_manifest: Pathlike, recording_manifest: Optional[Pathlike],
    feature_manifest: Optional[Pathlike], supervision_manifest: Optional[Pathlike],
    force_eager: bool):
    """
    Create a CutSet in OUTPUT_CUT_MANIFEST from any combination of
    recording/feature/supervision manifests (at least one of
    recording/feature required).
    """
    def maybe_load(p):
        return load_manifest_lazy_or_eager(p) if p is not None else None

    manifests = dict(
        recordings=maybe_load(recording_manifest), supervisions=maybe_load(supervision_manifest),
        features=maybe_load(feature_manifest))
    all_lazy = all(m is None or m.is_lazy for m in manifests.values())
    if all_lazy and not force_eager:
        CutSet.from_manifests(output_path=output_cut_manifest, lazy=True, **manifests)
    else:
        CutSet.from_manifests(**manifests).to_file(output_cut_manifest)


@cut.command()
@click.argument("cuts", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.argument("output_cuts", type=click.Path(allow_dash=True))
@click.option(
    "--keep-overlapping/--discard-overlapping", type=bool, default=True,
    help="When False, discard parts of other supervisions that overlap with " "the main supervision.",
)
@click.option(
    "-d", "--min-duration", type=float, default=None,
    help="Pad shorter cuts with surrounding acoustic context up to this length.")
@click.option(
    "-c", "--context-direction", type=click.Choice(["center", "left", "right", "random"]),
    default="center", help="Side(s) on which the acoustic context is added.")
@click.option(
    "--keep-all-channels/--discard-extra-channels", type=bool, default=False,
    help="For multi-channel cuts: keep the full channel set in each trimmed "
    "cut instead of only the supervision's channel(s).")
def trim_to_supervisions(
    cuts: Pathlike, output_cuts: Pathlike, keep_overlapping: bool, min_duration: Optional[float],
    context_direction: str, keep_all_channels: bool):
    """
    Split each input cut into one cut per supervision, spanning exactly the
    supervision's time span.
    """
    _stream_out(
        CutSet.from_file(cuts).trim_to_supervisions( keep_overlapping=keep_overlapping, min_duration=min_duration, context_direction=context_direction, keep_all_channels=keep_all_channels, ),
        output_cuts)


@cut.command()
@click.argument("cuts", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.argument("output_cuts", type=click.Path(allow_dash=True))
@click.option("--type", type=str, default="word", help="Which alignment tier drives the trimming")
@click.option(
    "--max-pause", type=float, default=0.0,
    help="Alignment items closer than this pause merge into one span")
@click.option(
    "--delimiter", "-d", type=str, default=" ",
    help="Joiner placed between merged alignment symbols")
@click.option(
    "--keep-all-channels/--discard-extra-channels", type=bool, default=False,
    help="For multi-channel cuts: keep the full channel set in each trimmed "
    "cut instead of only the supervision's channel(s).")
def trim_to_alignments(
    cuts: Pathlike, output_cuts: Pathlike, type: str, max_pause: float, delimiter: str,
    keep_all_channels: bool):
    """
    New CutSet with cuts spanning the alignments of type TYPE; contiguous
    alignment items within MAX_PAUSE are merged.
    """
    _stream_out(
        CutSet.from_file(cuts).trim_to_alignments( type=type, max_pause=max_pause, delimiter=delimiter, keep_all_channels=keep_all_channels ),
        output_cuts)


@cut.command()
@click.argument("cuts", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.argument("output_cuts", type=click.Path(allow_dash=True))
@click.option(
    "--max-pause", type=float, default=0.0,
    help="Supervisions closer than this pause form one group")
def trim_to_supervision_groups(cuts: Pathlike, output_cuts: Pathlike, max_pause: float):
    """
    New CutSet with cuts spanning supervision groups (supervisions that
    overlap or are separated by less than MAX_PAUSE).
    """
    _stream_out(CutSet.from_file(cuts).trim_to_supervision_groups(max_pause=max_pause), output_cuts)


@cut.command()
@click.argument("cut_manifests", nargs=-1, type=click.Path(exists=True, dir_okay=False))
@click.argument("output_cut_manifest", type=click.Path())
def mix_sequential(cut_manifests: List[Pathlike], output_cut_manifest: Pathlike):
    """
    Mix cuts position-wise across CUT_MANIFESTS (first with first, etc.),
    stopping at the shortest manifest.
    """
    streams = [CutSet.from_file(path) for path in cut_manifests]
    _stream_out((mix_cuts(group) for group in zip(*streams)), output_cut_manifest)


@cut.command()
@click.argument("cut_manifests", nargs=-1, type=click.Path(exists=True, dir_okay=False))
@click.argument("output_cut_manifest", type=click.Path())
def mix_by_recording_id(cut_manifests: List[Pathlike], output_cut_manifest: Pathlike):
    """
    Mix cuts from CUT_MANIFESTS matched by their recording IDs.
    """
    from lhotse_tpu_torch.manipulation import combine

    by_recording = defaultdict(list)
    for c in combine(*(CutSet.from_file(path) for path in cut_manifests)):
        by_recording[c.recording_id].append(c)
    CutSet.from_cuts(
        mix_cuts(group) for group in by_recording.values()
    ).to_file(output_cut_manifest)


@cut.command(context_settings=dict(show_default=True))
@click.argument("cut_manifest", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.argument("output_cut_manifest", type=click.Path(allow_dash=True))
@click.option(
    "--preserve-id", is_flag=True,
    help="Keep the original cut IDs (new random IDs are assigned otherwise).")
@click.option(
    "-d", "--max-duration", type=float, required=True,
    help="Upper bound (seconds) on cut duration in the output manifest.")
@click.option(
    "-o", "--offset-type", type=click.Choice(["start", "end", "random"]), default="start",
    help="Anchor of the truncation window within the original cut.")
@click.option(
    "--keep-overflowing-supervisions/--discard-overflowing-supervisions", type=bool, default=False,
    help="Retain supervisions that the truncation slices through.")
def truncate(
    cut_manifest: Pathlike, output_cut_manifest: Pathlike, preserve_id: bool, max_duration: float,
    offset_type: str, keep_overflowing_supervisions: bool):
    """
    Truncate cuts to MAX_DURATION (shorter cuts are unmodified).
    """
    shortened = CutSet.from_file(cut_manifest).truncate(
        max_duration=max_duration, offset_type=offset_type,
        keep_excessive_supervisions=keep_overflowing_supervisions, preserve_id=preserve_id)
    shortened.to_file(output_cut_manifest)


@cut.command()
@click.argument("cut_manifests", nargs=-1, type=click.Path(exists=True, dir_okay=False))
@click.argument("output_cut_manifest", type=click.Path())
def append(cut_manifests: List[Pathlike], output_cut_manifest: Pathlike):
    """
    Append cuts position-wise across CUT_MANIFESTS, in argument order,
    stopping at the shortest manifest.
    """
    streams = [CutSet.from_file(path) for path in cut_manifests]
    _stream_out((append_cuts(group) for group in zip(*streams)), output_cut_manifest)


@cut.command()
@click.argument("cut_manifest", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.argument("output_cut_manifest", type=click.Path(allow_dash=True))
@click.option(
    "-d", "--duration", default=None, type=float,
    help="Target length after right-padding (defaults to the longest cut).")
def pad(cut_manifest: Pathlike, output_cut_manifest: Pathlike, duration: Optional[float]):
    """
    Right-pad the cuts in CUT_MANIFEST.
    """
    CutSet.from_file(cut_manifest).pad(duration=duration).to_file(output_cut_manifest)


@cut.command(context_settings=dict(show_default=True))
@click.argument("cutset", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.argument("wspecifier", type=str)
@click.option(
    "-s", "--shard-size", type=int,
    help="Number of cuts per shard (sharding disabled if not defined).")
@click.option(
    "-f", "--audio-format", type=str, default="flac",
    help="Format in which the audio is encoded.")
@click.option("--audio/--no-audio", default=True, help="Load and add audio data.")
@click.option("--features/--no-features", default=True, help="Load and add feature data.")
@click.option("--custom/--no-custom", default=True, help="Load and add custom data.")
@click.option(
    "--fault-tolerant/--stop-on-fail", default=True,
    help="Omit cuts whose data failed to load, or stop the execution.")
def export_to_webdataset(
    cutset: Pathlike, wspecifier: str, shard_size: Optional[int], audio_format: str,
    audio: bool, features: bool, custom: bool, fault_tolerant: bool):
    """
    Export CUTSET into a WebDataset tarfile (or shards) at WSPECIFIER.

    \\b
    WSPECIFIER can be:
    - a regular path (e.g., "data/cuts.tar"),
    - a path template for sharding (e.g., "data/shard-%06d.tar"), or
    - a "pipe:" expression (e.g., "pipe:gzip -c > data/shard-%06d.tar.gz").

    Read back with 'CutSet.from_webdataset'.
    """
    from lhotse_tpu_torch.dataset.webdataset import export_to_webdataset as export_

    export_(
        cuts=CutSet.from_file(cutset), output_path=wspecifier, shard_size=shard_size,
        audio_format=audio_format, load_audio=audio, load_features=features,
        load_custom=custom, fault_tolerant=fault_tolerant)


@cut.command()
@click.argument("cutset", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.argument("output", type=click.Path())
def decompose(cutset: Pathlike, output: Pathlike):
    """
    \b
    Decompose CUTSET into:
        * recording set (recordings.jsonl.gz)
        * feature set (features.jsonl.gz)
        * supervision set (supervisions.jsonl.gz)
    """
    CutSet.from_file(cutset).decompose(output_dir=Path(output), verbose=True)


@cut.command()
@click.argument("cutset", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
def describe(cutset: Pathlike):
    """
    Describe statistics of CUTSET (total speech/audio duration etc.).
    """
    CutSet.from_file(cutset).describe()


@cut.command()
@click.argument("cutset", type=click.Path(exists=True, dir_okay=False, allow_dash=True))
@click.option("-b", "--num-buckets", default=30, type=int, help="How many duration buckets to estimate.")
@click.option(
    "-s", "--sample", default=None, type=int,
    help="Estimate from this many cuts only (default: all of them).")
def estimate_bucket_bins(cutset: Pathlike, num_buckets: int, sample: Optional[int]) -> None:
    """
    Estimate duration bins for dynamic bucketing (prints up to
    num_buckets-1 floats; skewed length distributions may yield fewer).
    """
    from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import estimate_duration_buckets

    cuts = load_manifest_lazy_or_eager(cutset)
    if sample is not None:
        cuts = cuts.subset(first=sample)
    click.echo(estimate_duration_buckets(cuts, num_buckets=num_buckets))
