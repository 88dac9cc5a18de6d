"""
ADEPT recipe (copied from ``lhotse_tpu/recipes/adept.py``): a benchmark of
prosodically marked-up English speech for evaluating prosody transfer in
TTS (Zenodo record 5117102)::

    ADEPT/
      wav_44khz/<annotation_type>/<label>/<prompt>.wav
      txt/<annotation_type>/<label>/<prompt>.txt
      adept_prompts.json        # interpretation texts per prompt/label

The download is not ported.
"""
import json
from pathlib import Path
from typing import Optional

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import Pathlike


def _flat_id(path: Path) -> str:
    # .../<annotation_type>/<label>/<prompt>.wav -> type_label_prompt
    return str(path.relative_to(path.parent.parent.parent))[:-4].replace("/", "_")


def prepare_adept(corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None):
    """ADEPT manifests; prosody class/label/interpretation in custom fields."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    recordings = RecordingSet.from_recordings(
        Recording.from_file(path=wav, recording_id=_flat_id(wav))
        for wav in (corpus_dir / "wav_44khz").rglob("*.wav")
    )
    interpretations = json.loads((corpus_dir / "adept_prompts.json").read_text())

    supervisions = []
    for txt in (corpus_dir / "txt").rglob("*.txt"):
        annotation_type, label, prompt_id = str(
            txt.relative_to(txt.parent.parent.parent)
        )[:-4].split("/")
        rec_id = f"{annotation_type}_{label}_{prompt_id}"
        custom = {"type": annotation_type, "label": label, "prompt_id": prompt_id}
        group = interpretations.get(annotation_type)
        if group:
            custom["text"] = group[prompt_id][label]
        rec = recordings[rec_id]
        supervisions.append(
            SupervisionSegment(
                id=rec_id,
                recording_id=rec_id,
                start=0,
                duration=rec.duration,
                channel=0,
                text=txt.read_text().strip(),
                language="English",
                speaker=f"ADEPT_{prompt_id.split('_')[0]}",
                custom=custom,
            )
        )
    return finalize_manifests(
        recordings, supervisions, output_dir=output_dir, prefix="adept", part="all")
