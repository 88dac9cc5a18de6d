"""
Multilingual LibriSpeech (MLS) recipe (openslr/94; copied from
``lhotse_tpu/recipes/mls.py``): audiobooks in eight languages (English,
German, Dutch, Spanish, French, Italian, Portuguese, Polish), as 16 kHz FLAC
(``mls_<language>``) or 48 kHz Opus decoded at 16 kHz
(``mls_<language>_opus``).

Per language: ``metainfo.txt`` maps speakers to genders (``|``-separated),
each split has a ``transcripts.txt`` of tab-separated id and text, and the
speaker id is the first ``_``-field of the utterance id.
"""
import logging
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def prepare_mls(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None, opus: bool = True,
    num_jobs: int = 1) -> Dict[str, Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]]:
    """
    Prepare MLS manifests: ``result[language][split] = {recordings,
    supervisions}`` for splits test/dev/train.

    :param opus: scan for OPUS files (else FLAC).
    """
    corpus_dir = Path(corpus_dir)
    output_dir = Path(output_dir) if output_dir is not None else None
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"

    languages = {
        d.name.split("_")[1]: d
        for d in sorted(corpus_dir.glob("mls_*"))
        if d.is_dir()
        and "_lm_" not in d.name
        and (opus or not d.name.endswith("opus"))
    }
    logging.info(f"Found MLS languages: {list(languages)}")

    manifests = defaultdict(dict)
    for lang, lang_dir in languages.items():
        logging.info(f"Processing language: {lang}")
        spk2gender = {}
        for line in (lang_dir / "metainfo.txt").read_text().splitlines():
            fields = line.split("|")
            if len(fields) >= 2:
                spk2gender[fields[0].strip()] = fields[1].strip()

        for split in ("test", "dev", "train"):
            recordings_path = (
                None
                if output_dir is None
                else output_dir / f"mls-{lang}_recordings_{split}.jsonl.gz"
            )
            supervisions_path = (
                None
                if output_dir is None
                else output_dir / f"mls-{lang}_supervisions_{split}.jsonl.gz"
            )
            if (
                recordings_path is not None
                and recordings_path.is_file()
                and supervisions_path.is_file()
            ):
                logging.info(f"Skipping - {lang}/{split} - already exists!")
                manifests[lang][split] = {
                    "recordings": RecordingSet.from_file(recordings_path),
                    "supervisions": SupervisionSet.from_file(supervisions_path)}
                continue

            split_dir = lang_dir / split
            recordings = RecordingSet.from_dir(
                path=split_dir, pattern="*.opus" if opus else "*.flac", num_jobs=num_jobs,
                force_opus_sampling_rate=16000)
            def parse_row(line: str) -> SupervisionSegment:
                recording_id, text = line.split("\t")
                speaker = recording_id.split("_")[0]
                return SupervisionSegment(
                    id=recording_id, recording_id=recording_id, text=text, speaker=speaker,
                    gender=spk2gender.get(speaker), start=0.0,
                    duration=recordings.duration(recording_id), language=lang)

            transcript_rows = (split_dir / "transcripts.txt").read_text().splitlines()
            supervisions = SupervisionSet.from_segments(parse_row(line) for line in transcript_rows)
            recordings, supervisions = fix_manifests(recordings, supervisions)
            validate_recordings_and_supervisions(recordings, supervisions)
            manifests[lang][split] = {"recordings": recordings, "supervisions": supervisions}
            if output_dir is not None:
                output_dir.mkdir(exist_ok=True, parents=True)
                recordings.to_file(recordings_path)
                supervisions.to_file(supervisions_path)
    return dict(manifests)
