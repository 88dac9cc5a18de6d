"""
Workflow commands (copied from ``lhotse_tpu/bin/modes/workflows.py``):
``activity-detection`` and ``simulate-meetings``. The Whisper, DNSMOS and
alignment commands wait for their workflows (see ROADMAP.md).
"""
from typing import Optional

import click

from lhotse_tpu_torch.bin.modes.cli_base import cli
from lhotse_tpu_torch.utils import Pathlike


@cli.group()
def workflows():
    """Workflows using corpus creation tools."""
    pass


@workflows.command(context_settings=dict(show_default=True))
@click.argument("in_cuts", type=click.Path(exists=True, dir_okay=False))
@click.argument("out_cuts", type=click.Path(allow_dash=True))
@click.option(
    "-m", "--method", type=click.Choice(["independent", "conversational"]), default="independent",
    help="Meeting simulation method.")
@click.option(
    "--loc", type=float, default=0.0,
    help="[independent] Location (minimum) of the inter-utterance pause distribution.")
@click.option(
    "--scale", type=float, default=2.0,
    help="[independent] Scale (mean above loc) of the inter-utterance pause distribution.")
@click.option(
    "--same-spk-pause", type=float, default=1.0,
    help="[conversational] Mean pause between utterances of the same speaker.")
@click.option(
    "--diff-spk-pause", type=float, default=1.0,
    help="[conversational] Mean pause between utterances of different speakers.")
@click.option(
    "--diff-spk-overlap", type=float, default=2.0,
    help="[conversational] Mean overlap between utterances of different speakers.")
@click.option(
    "--prob-diff-spk-overlap", type=float, default=0.5,
    help="[conversational] Probability of overlap between different speakers.")
@click.option(
    "-f", "--fit-to-supervisions", type=click.Path(exists=True, dir_okay=False), default=None,
    help="Supervision manifest of a real corpus to fit the simulator's " "pause/overlap statistics to.",
)
@click.option(
    "--reverberate/--dont-reverberate", default=False,
    help="Reverberate the simulated meetings (synthetic RIRs unless --rir given).")
@click.option(
    "--rir-recordings", "--rir", type=click.Path(exists=True, dir_okay=True), default=None,
    help="RecordingSet manifest with RIRs (or a directory of such manifests) "
    "used for reverberation.")
@click.option(
    "-n", "--num-meetings", type=int, default=None,
    help="Number of meetings to simulate (supply this or --num-repeats).")
@click.option(
    "-r", "--num-repeats", type=int, default=1,
    help="How many times to use each utterance in the simulation.")
@click.option(
    "-s", "--num-speakers-per-meeting", type=str, default="2",
    help="Number of speakers per meeting (comma-separated list allowed, " "used with --speaker-count-probs).",
)
@click.option(
    "-p", "--speaker-count-probs", type=str, default=None,
    help="Comma-separated probabilities for each speaker count.")
@click.option(
    "-d", "--max-duration-per-speaker", type=float, default=20.0,
    help="Maximum speech duration of a single speaker in a meeting.")
@click.option(
    "-u", "--max-utterances-per-speaker", type=int, default=5,
    help="Maximum utterances per speaker in a meeting.")
@click.option(
    "--allow-3fold-overlap/--no-3fold-overlap", default=False,
    help="[conversational] Allow more than two simultaneous speakers.")
@click.option("--seed", type=int, default=0, help="Random seed.")
@click.option("-j", "--num-jobs", type=int, default=1, help="Parallel jobs.")
def simulate_meetings(
    in_cuts: Pathlike, out_cuts: Pathlike, method: str, loc: float, scale: float,
    same_spk_pause: float, diff_spk_pause: float, diff_spk_overlap: float,
    prob_diff_spk_overlap: float, fit_to_supervisions: Optional[Pathlike],
    reverberate: bool, rir_recordings: Optional[Pathlike],
    num_meetings: Optional[int], num_repeats: Optional[int], num_speakers_per_meeting: str,
    speaker_count_probs: Optional[str], max_duration_per_speaker: float,
    max_utterances_per_speaker: int, allow_3fold_overlap: bool, seed: int, num_jobs: int):
    """
    Simulate multi-speaker meetings from single-utterance cuts in IN_CUTS,
    writing mixed cuts to OUT_CUTS.
    """
    from pathlib import Path

    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.workflows import (
        ConversationalMeetingSimulator, SpeakerIndependentMeetingSimulator)

    cuts = CutSet.from_file(in_cuts)
    num_speakers = [int(x) for x in num_speakers_per_meeting.split(",")]
    probs = (
        [float(x) for x in speaker_count_probs.split(",")]
        if speaker_count_probs is not None
        else None
    )

    extra_simulate_kwargs = {}
    if method == "independent":
        simulator = SpeakerIndependentMeetingSimulator(loc=loc, scale=scale)
    else:
        simulator = ConversationalMeetingSimulator(
            same_spk_pause=same_spk_pause, diff_spk_pause=diff_spk_pause,
            diff_spk_overlap=diff_spk_overlap,
            prob_diff_spk_overlap=prob_diff_spk_overlap)
        extra_simulate_kwargs["allow_3fold_overlap"] = allow_3fold_overlap

    if fit_to_supervisions is not None:
        from lhotse_tpu_torch.supervision import SupervisionSet

        simulator.fit(SupervisionSet.from_file(fit_to_supervisions))

    mixed = simulator.simulate(
        cuts, num_meetings=num_meetings, num_repeats=num_repeats,
        num_speakers_per_meeting=num_speakers if len(num_speakers) > 1 else num_speakers[0],
        speaker_count_probs=probs, max_duration_per_speaker=max_duration_per_speaker,
        max_utterances_per_speaker=max_utterances_per_speaker, seed=seed, num_jobs=num_jobs,
        **extra_simulate_kwargs)

    if reverberate:
        from lhotse_tpu_torch.audio import RecordingSet

        if rir_recordings:
            rir_path = Path(rir_recordings)
            if rir_path.is_file():
                rirs = [RecordingSet.from_file(rir_path)]
            else:
                manifests = sorted(
                    p
                    for pattern in ("*.jsonl.gz", "*.jsonl", "*.json", "*.json.gz", "*.yaml")
                    for p in rir_path.glob(pattern)
                )
                if not manifests:
                    raise click.ClickException(
                        f"--rir directory {rir_path} contains no recording "
                        "manifests (*.jsonl[.gz], *.json[.gz], *.yaml)."
                    )
                rirs = [RecordingSet.from_file(p) for p in manifests]
            mixed = simulator.reverberate(mixed, *rirs)
        else:
            mixed = simulator.reverberate(mixed)

    mixed.to_file(out_cuts)


@workflows.command(context_settings=dict(show_default=True))
@click.option(
    "-r", "--recordings-manifest", required=True,
    type=click.Path(exists=True, dir_okay=False, allow_dash=True),
    help="Path to an existing recording manifest.")
@click.option(
    "-o", "--output-supervisions-manifest",
    type=click.Path(exists=False, dir_okay=True, allow_dash=True), default=None,
    help="Output supervisions manifest path (or a directory for it); defaults "
    "to '<recordings stem>_supervisions_<model>.jsonl.gz' next to the input.")
@click.option(
    "-m", "--model-name",
    type=click.Choice(["energy_vad", "silero_vad_8k", "silero_vad_16k"]),
    default="energy_vad",
    help="Activity detector (the Silero variants need torch.hub weights; "
    "energy_vad is model-free).")
@click.option("-d", "--device", default="cuda",
              help="Inference device (energy_vad runs on the host and ignores it).")
@click.option("-j", "--jobs", "--num-jobs", "jobs", type=int, default=1,
              help="Parallel jobs.")
@click.option(
    "--force_download", "--force-download", "force_download", is_flag=True, default=False,
    help="Clear any cached model state before running.")
@click.option(
    "-t", "--threshold", type=float, default=0.01,
    help="[energy_vad] Energy threshold (fraction of peak RMS).")
@click.option(
    "--min-duration", type=float, default=0.25,
    help="[energy_vad] Minimum speech segment length.")
def activity_detection(
    recordings_manifest: Pathlike, output_supervisions_manifest: Optional[Pathlike],
    model_name: str, device: str, jobs: int, force_download: bool, threshold: float,
    min_duration: float):
    """
    Detect speech activity in the recordings of RECORDINGS_MANIFEST and write
    the spans as a SupervisionSet manifest.
    """
    from functools import partial
    from itertools import chain
    from pathlib import Path

    from lhotse_tpu_torch.audio import RecordingSet
    from lhotse_tpu_torch.parallel import ParallelExecutor
    from lhotse_tpu_torch.supervision import SupervisionSet
    from lhotse_tpu_torch.workflows import EnergyVAD, SileroVAD8k, SileroVAD16k

    detectors = {
        "energy_vad": partial(EnergyVAD, threshold=threshold, min_duration=min_duration),
        "silero_vad_8k": SileroVAD8k,
        "silero_vad_16k": SileroVAD16k,
    }
    detector_kls = detectors[model_name]

    recs_path = Path(recordings_manifest).expanduser().absolute()
    if output_supervisions_manifest is None:
        sups_path = recs_path.parent
    else:
        sups_path = Path(output_supervisions_manifest).expanduser().absolute()
    if sups_path.is_dir():
        name = recs_path.name
        for ext in (".gz", ".jsonl", ".json", ".yaml"):
            if name.endswith(ext):
                name = name[: -len(ext)]
        sups_path = sups_path / f"{name}_supervisions_{model_name}.jsonl.gz"

    recordings = RecordingSet.from_file(str(recs_path))
    if force_download:
        (EnergyVAD if model_name == "energy_vad" else detectors[model_name]).force_download()
    processor = ParallelExecutor(
        init_fn=partial(detector_kls, device=device), num_jobs=jobs,
        description="Running VAD")
    supervisions = SupervisionSet.from_segments(chain.from_iterable(processor(recordings)))
    supervisions.to_file(str(sups_path))
    click.echo(f"Results saved to: {sups_path}")
