"""
Workflow commands (copied from ``lhotse_tpu/bin/modes/workflows.py``):
``simulate-meetings`` only. The activity-detection, Whisper, DNSMOS and
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
