"""
Switchboard-1 recipe (LDC97S62; copied from
``lhotse_tpu/recipes/switchboard.py``): about 300 h of two-channel 8 kHz
telephone conversations in SPHERE, with the MS-State word transcripts (one
``*trans.text`` file for every side of a conversation) and, optionally,
the LDC2020T14 sentiment annotations. ``download_and_untar`` is not ported:
it needs the network, so ``transcripts_dir`` must be given.
"""
import logging
from itertools import chain
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, check_and_rglob, not_ported


def make_segments(
    transcript_path: Path, recording: Recording, channel: int, omit_silence: bool = True):
    """One `*trans.text` file: `<segment_id> <start> <end> <words...>`."""
    side = "A" if channel == 0 else "B"
    return [
        SupervisionSegment(
            id=segment_id,
            recording_id=recording.id,
            start=float(start),
            duration=round(float(end) - float(start), ndigits=8),
            channel=channel,
            text=" ".join(words),
            language="English",
            speaker=f"{recording.id}{side}",
        )
        for segment_id, start, end, *words in map(
            str.split, transcript_path.read_text().splitlines()
        )
        if words and (words[0] != "[silence]" or not omit_silence)
    ]


def prepare_switchboard(
    audio_dir: Pathlike, transcripts_dir: Optional[Pathlike] = None,
    sentiment_dir: Optional[Pathlike] = None, output_dir: Optional[Pathlike] = None,
    omit_silence: bool = True, absolute_paths: bool = False,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """
    One "all" split of recordings + supervisions; with ``sentiment_dir``
    (LDC2020T14), sentiment labels are attached to matching segments.
    """
    if transcripts_dir is None:
        raise not_ported("Downloading the Switchboard transcripts (download_and_untar)")
    audio_paths = check_and_rglob(audio_dir, "*.sph")
    text_paths = check_and_rglob(transcripts_dir, "*trans.text")

    name_to_text = {p.stem.split("-")[0]: p for p in text_paths}
    groups = []
    for ap in audio_paths:
        name = ap.stem.replace("sw0", "sw")
        groups.append(
            {
                "audio": ap,
                "text-0": name_to_text[f"{name}A"],
                "text-1": name_to_text[f"{name}B"],
            }
        )

    recordings = RecordingSet.from_recordings(
        Recording.from_file(
            group["audio"],
            relative_path_depth=None if absolute_paths else 3,
        )
        for group in groups
    )
    supervisions = SupervisionSet.from_segments(
        chain.from_iterable(
            make_segments(
                transcript_path=group[f"text-{channel}"],
                recording=recording,
                channel=channel,
                omit_silence=omit_silence,
            )
            for group, recording in zip(groups, recordings)
            for channel in (0, 1)
        )
    )
    recordings, supervisions = fix_manifests(recordings, supervisions)
    validate_recordings_and_supervisions(recordings, supervisions)

    if sentiment_dir is not None:
        parse_and_add_sentiment_labels(sentiment_dir, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        recordings.to_file(output_dir / "swbd_recordings_all.jsonl.gz")
        supervisions.to_file(output_dir / "swbd_supervisions_all.jsonl.gz")
    return {"recordings": recordings, "supervisions": supervisions}


def parse_and_add_sentiment_labels(sentiment_dir: Pathlike, supervisions: SupervisionSet) -> None:
    """LDC2020T14 `sentiment_labels.tsv`: id/start/end/annotator#labels."""
    sentiment_dir = Path(sentiment_dir)
    labels_path = sentiment_dir / "data" / "sentiment_labels.tsv"
    assert sentiment_dir.is_dir() and labels_path.is_file()
    matched = 0
    for line in labels_path.read_text().splitlines():
        fields = line.split("\t")
        if len(fields) < 4:
            continue
        seg_id, start, end, sentiment = fields[:4]
        call_id = seg_id.split("_")[0]
        matches = list(
            supervisions.find(
                recording_id=call_id,
                start_after=float(start) - 1e-2,
                end_before=float(end) + 1e-2,
            )
        )
        if not matches:
            continue
        matched += 1
        labels = sentiment.split("#")
        # .find() returns references: annotate the set's segments in place.
        for segment in matches:
            segment.custom = {f"sentiment{i}": label for i, label in enumerate(labels)}
    logging.info(f"Attached sentiment labels to {matched} annotation spans.")
