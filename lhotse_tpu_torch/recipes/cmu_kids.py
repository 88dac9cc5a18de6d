"""
CMU Kids recipe (copied from ``lhotse_tpu/recipes/cmu_kids.py``): read-aloud
sentences by children aged 6-11 (LDC97S63)::

    cmu_kids/
      tables/sentence.tbl    # <utt-id> \\t <count> \\t <prompt text>
      tables/speaker.tbl     # 2 header lines, then <spk> \\t <pop> \\t <gr/age> ...
      tables/transcrp.tbl    # <trn-id> <spoken transcript>; trn-id = spk(4)+utt(3)+bin(1)
      kids/<spk>/signal/<trn-id>.sph

There is no official split; everything lands in one "all" partition. "bin" 1
marks clean reads, 2 marks noisy/mispronounced ones. The corpus is
LDC-licensed, so there is no download.
"""
import logging
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def _read_prompts(tables: Path) -> Dict[str, str]:
    prompts = {}
    for line in (tables / "sentence.tbl").read_text().splitlines():
        if line.strip():
            utt, _, text = line.strip().split("\t")
            prompts[utt] = text
    return prompts


def _read_speakers(tables: Path) -> Dict[str, tuple]:
    speakers = {}
    lines = (tables / "speaker.tbl").read_text().splitlines()
    for line in lines[2:]:  # two header lines
        if not line.strip():
            continue
        spk, population, grade_age, _, _ = line.strip().split("\t")
        grade, age = grade_age.split("/")
        speakers[spk] = (population, grade, age)
    return speakers


def prepare_cmu_kids(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    absolute_paths: Optional[bool] = True) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """
    Build CMU Kids manifests. Supervisions carry the prompt as ``text`` and,
    under ``custom``: speaker grade/age/population, the transcript as spoken
    (with noise tags), and the transcription bin (1 = clean, 2 = noisy).
    """
    corpus_dir = Path(corpus_dir)
    if corpus_dir.stem == "cmu_kids":
        corpus_dir = corpus_dir.parent
    tables = corpus_dir / "cmu_kids" / "tables"

    prompts = _read_prompts(tables)
    speakers = _read_speakers(tables)

    recordings, supervisions = [], []
    for line in (tables / "transcrp.tbl").read_text().splitlines():
        if not line.strip():
            continue
        trn_id, spoken = line.strip().split(maxsplit=1)
        spk, utt, tbin = trn_id[:4], trn_id[4:7], int(trn_id[7])
        population, grade, age = speakers[spk]
        sph = corpus_dir / "cmu_kids" / "kids" / spk / "signal" / f"{trn_id}.sph"
        rec = Recording.from_file(sph, relative_path_depth=None if absolute_paths else 3)
        recordings.append(rec)
        supervisions.append(
            SupervisionSegment(
                id=trn_id,
                recording_id=trn_id,
                start=0,
                duration=rec.duration,
                speaker=spk,
                gender="Male" if spk.startswith("m") else "Female",
                language="English",
                text=prompts[utt],
                custom={
                    "speaker_grade": grade if grade != "NA" else None,
                    "speaker_age": int(age) if age != "NA" else None,
                    "speaker_population": population,
                    "bin": tbin,
                    "spoken_transcript": spoken,
                },
            )
        )

    logging.info(f"Prepared {len(recordings)} CMU Kids utterances.")
    return finalize_manifests(
        recordings, supervisions, output_dir=output_dir, prefix="cmu-kids", part="all")
