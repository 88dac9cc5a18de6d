"""
CMU INDIC recipe (copied from ``lhotse_tpu/recipes/cmu_indic.py``): 13
phonetically balanced single-speaker TTS databases across 8 Indian
languages (http://festvox.org/cmu_indic/), one ``cmu_indic_<spk>`` package
each with ``wav/*.wav``, ``etc/txt.done.data`` and, for some speakers,
``etc/voice.feats`` (the age). The language comes from the speaker prefix;
an ``arctic`` prompt is English read with that language as its accent.
A ``txt.done.data`` line is cut as ``line[2:-2]`` without a strip, as in
the JAX package. The download is not ported.
"""
from pathlib import Path
from typing import Dict, Optional, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.recipes.utils import finalize_manifests
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

SPEAKERS = (
    "ben_rm", "guj_ad", "guj_dp", "guj_kt", "hin_ab", "kan_plv", "mar_aup", "mar_slp",
    "pan_amp", "tam_sdr", "tel_kpn", "tel_sk", "tel_ss")

GENDER_MAP = {
    "tel_kpn": "F", "hin_ab": "F", "kan_plv": "F", "ben_rm": "F", "guj_ad": "M",
    "mar_slp": "F", "guj_dp": "F", "tam_sdr": "F", "guj_kt": "F", "pan_amp": "F",
    "tel_ss": "F", "tel_sk": "M", "mar_aup": "M"}

LANGUAGE_MAP = {
    "ben": "Bengali", "guj": "Gujarati", "kan": "Kannada", "hin": "Hindi",
    "mar": "Marathi", "pan": "Punjabi", "tam": "Tamil", "tel": "Telugu"}


def _speaker_of(dirname: str) -> str:
    # "cmu_indic_ben_rm" -> "ben_rm"
    return dirname.split("_", maxsplit=2)[2]


def _read_age(voice_feats: Path) -> Optional[int]:
    try:
        return int(voice_feats.read_text().splitlines()[1].replace("age ", "").strip())
    except Exception:
        return None


def prepare_cmu_indic(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Single-part manifests across every unpacked cmu_indic_* package."""
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    recordings = RecordingSet.from_recordings(
        Recording.from_file(
            wav, recording_id=f"{_speaker_of(wav.parent.parent.name)}-{wav.stem}")
        for wav in corpus_dir.rglob("*.wav"))

    supervisions = []
    for path in corpus_dir.rglob("txt.done.data"):
        speaker = _speaker_of(path.parent.parent.name)
        language = LANGUAGE_MAP[speaker.split("_")[0]]
        age = _read_age(path.parent / "voice.feats")
        for line in path.read_text().splitlines():
            line = line[2:-2]  # strip "( " and " )"
            seg_id, text = line.split(maxsplit=1)
            seg_id = f"{speaker}-{seg_id}"
            is_english = "arctic" in seg_id  # English arctic prompts read with accent
            custom = {}
            if is_english:
                custom["accent"] = language
            if age is not None:
                custom["age"] = age
            supervisions.append(
                SupervisionSegment(
                    id=seg_id, recording_id=seg_id, start=0,
                    duration=recordings[seg_id].duration, text=text.replace('"', ""),
                    language="English" if is_english else language, speaker=speaker,
                    gender=GENDER_MAP.get(speaker), custom=custom or None))
    return finalize_manifests(
        recordings, supervisions, output_dir=output_dir, prefix="cmu-indic", part="all")
