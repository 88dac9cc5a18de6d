"""
CMU ARCTIC recipe (copied from ``lhotse_tpu/recipes/cmu_arctic.py``):
phonetically balanced single-speaker TTS databases (about 1,150 utterances
per speaker, 16 kHz). Layout per speaker::

    cmu_us_<spk>_arctic/
      wav/arctic_{a,b}NNNN.wav
      etc/txt.done.data      # ( arctic_a0001 "Prompt text." ) per line

Recording/supervision ids take the form ``<spk>-arctic_a0001``. A prompt
without a recording is dropped (the JAX package looks its recording up and
raises ``KeyError``). The download is not ported.
"""
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

SPEAKERS = (
    "aew", "ahw", "aup", "awb", "axb", "bdl", "clb", "eey", "fem", "gka", "jmk", "ksp", "ljm",
    "lnh", "rms", "rxr", "slp", "slt")

# Metadata that is readily documented; other speakers stay unannotated.
GENDERS = {
    "bdl": "male", "rms": "male", "jmk": "male", "awb": "male", "ksp": "male", "slt": "female",
    "clb": "female"}
ACCENTS = {
    "bdl": "US Midwest", "slt": "US Midwest", "clb": "US", "rms": "US", "jmk": "Canadian Ontario",
    "awb": "Scottish South Eastern", "ksp": "Indian"}
# The name the reference lhotse recipe gives ACCENTS.
ACCENT_MAP = ACCENTS


def _speaker_of(package_dir_name: str) -> str:
    # cmu_us_<spk>_arctic -> <spk>
    return package_dir_name.split("_")[2]


def prepare_cmu_arctic(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """CMU ARCTIC manifests over every downloaded speaker package."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")

    recordings = RecordingSet.from_recordings(
        Recording.from_file(
            wav, recording_id=f"{_speaker_of(wav.parent.parent.name)}-{wav.stem}"
        )
        for wav in corpus_dir.rglob("*.wav")
    )

    supervisions = []
    for prompts in corpus_dir.rglob("txt.done.data"):
        spk = _speaker_of(prompts.parent.parent.name)
        for line in prompts.read_text().splitlines():
            # Each line: ( arctic_a0001 "Author of the danger trail." )
            body = line.strip()[2:-2]
            utt, text = body.split(maxsplit=1)
            seg_id = f"{spk}-{utt}"
            if seg_id not in recordings:
                continue  # a prompt nobody recorded (the JAX package raises KeyError)
            supervisions.append(
                SupervisionSegment(
                    id=seg_id,
                    recording_id=seg_id,
                    start=0,
                    duration=recordings[seg_id].duration,
                    text=text.replace('"', ""),
                    language="English",
                    speaker=spk,
                    gender=GENDERS.get(spk),
                    custom={"accent": ACCENTS.get(spk)},
                )
            )

    # A handful of prompts have no recording (or vice versa) upstream.
    return finalize_manifests(
        recordings, supervisions, output_dir=output_dir, prefix="cmu-arctic", part="all")
