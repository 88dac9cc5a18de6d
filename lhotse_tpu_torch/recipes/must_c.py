"""
MuST-C recipe (copied from ``lhotse_tpu/recipes/must_c.py``): multilingual
speech translation built from English TED talks, one ``en-{tgt}`` package
per target language (https://ict.fbk.eu/must-c-releases/). Each of the
splits dev, tst-COMMON, tst-HE and train has a ``txt/{split}.yaml`` table of
segments and a parallel transcript file in the target language; the rows
are grouped by their wav. The corpus is distributed through a request form,
so there is no download.
"""
import logging
from pathlib import Path
from typing import Dict, List, Tuple, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.serialization import load_yaml
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike, Seconds

MUST_C_SPLITS = ("dev", "tst-COMMON", "tst-HE", "train")


def parse_utterance(
    wave_dir: Path, group: Tuple[List[dict], List[str]], tgt_lang: str,
) -> Tuple[Recording, List[SupervisionSegment]]:
    """One wav's (Recording, supervisions) from its segment rows + texts."""
    wave_segments, transcripts = group
    assert len(wave_segments) == len(transcripts), (len(wave_segments), len(transcripts))
    recording = Recording.from_file(wave_dir / wave_segments[0]["wav"])
    segments = [
        SupervisionSegment(
            id=f"{recording.id}-seg-{i}", recording_id=recording.id,
            start=Seconds(seg["offset"]), duration=round(Seconds(seg["duration"]), 8),
            channel=0, language=tgt_lang, speaker=seg["speaker_id"], text=text)
        for i, (seg, text) in enumerate(zip(wave_segments, transcripts))]
    return recording, segments


def _group_segments(segments: List[dict], transcripts: List[str]):
    """Pair the yaml rows with their transcripts, grouped by source wav in
    the order of each wav's first row. The JAX package groups adjacent rows
    only (``itertools.groupby``), so a wav whose rows are not adjacent
    becomes two recordings of one id, which ``fix_manifests`` refuses."""
    assert len(segments) == len(transcripts), (len(segments), len(transcripts))
    groups = {}
    for row, text in zip(segments, transcripts):
        rows, texts = groups.setdefault(row["wav"], ([], []))
        rows.append(row)
        texts.append(text)
    return list(groups.values())


def prepare_must_c(
    corpus_dir: Pathlike, output_dir: Pathlike, tgt_lang: str, num_jobs: int = 1,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """Per-split manifests for one ``en-{tgt_lang}`` package."""
    src_lang = "en"
    in_data_dir = Path(corpus_dir) / f"{src_lang}-{tgt_lang}/data"
    assert in_data_dir.is_dir(), in_data_dir
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    manifests = {}
    for split in MUST_C_SPLITS:
        logging.info(f"Processing {split}")
        dataset_dir = in_data_dir / split
        assert dataset_dir.is_dir(), dataset_dir
        transcripts = [
            line.strip()
            for line in (dataset_dir / "txt" / f"{split}.{tgt_lang}")
            .read_text().splitlines()]
        segments = load_yaml(dataset_dir / "txt" / f"{split}.yaml")
        assert len(transcripts) == len(segments), (len(transcripts), len(segments))

        recording_list, supervision_list = [], []
        for group in _group_segments(segments, transcripts):
            recording, sups = parse_utterance(dataset_dir / "wav", group, tgt_lang)
            recording_list.append(recording)
            supervision_list.extend(sups)
        recordings, supervisions = fix_manifests(
            recordings=RecordingSet.from_recordings(recording_list),
            supervisions=SupervisionSet.from_segments(supervision_list))
        validate_recordings_and_supervisions(
            recordings=recordings, supervisions=supervisions)
        recordings.to_file(
            output_dir / f"must_c_recordings_{src_lang}-{tgt_lang}_{split}.jsonl.gz")
        supervisions.to_file(
            output_dir / f"must_c_supervisions_{src_lang}-{tgt_lang}_{split}.jsonl.gz")
        manifests[split] = {"recordings": recordings, "supervisions": supervisions}
    return manifests
