"""
"RIRs and Noises" (OpenSLR 28; copied from ``lhotse_tpu/recipes/rir_noise.py``):
point-source noises, isotropic noises, real room impulse responses (RWCP,
REVERB 2014, Aachen AIR) and simulated ones, the standard reverberation
and noise augmentation package. Its ``real_rir`` part feeds
``ReverbWithImpulseResponse`` and the ``rir`` of ``OnDeviceAugmenter``.

Layout::

    RIRS_NOISES/
      pointsource_noises/*.wav
      real_rirs_isotropic_noises/*.wav   # "*noise*" = iso noise, "*rir*" = RIR
      simulated_rirs/{small,medium,large}room/**/*.wav

``download_rir_noise`` is not ported: it needs the network.
"""
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.utils import Pathlike


_PART_DIRS = {
    "point_noise": "pointsource_noises", "iso_noise": "real_rirs_isotropic_noises",
    "real_rir": "real_rirs_isotropic_noises", "sim_rir": "simulated_rirs"}
PARTS = _PART_DIRS


def _collect(part: str, audio_dir: Path) -> RecordingSet:
    if part == "sim_rir":
        # Room sizes reuse file names; prefix the room type to keep ids unique.
        recs = [
            Recording.from_file(wav, recording_id=f"{room}-{wav.stem}")
            for room in ("small", "medium", "large")
            for wav in (audio_dir / f"{room}room").rglob("*.wav")
        ]
        return RecordingSet.from_recordings(recs)
    wavs = audio_dir.rglob("*.wav")
    if part == "iso_noise":
        wavs = (w for w in wavs if "noise" in w.stem)
    elif part == "real_rir":
        wavs = (w for w in wavs if "rir" in w.stem)
    return RecordingSet.from_recordings(Recording.from_file(w) for w in wavs)


def prepare_rir_noise(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    parts: Sequence[str] = ("point_noise", "iso_noise", "real_rir", "sim_rir"),
) -> Dict[str, Dict[str, Union[RecordingSet, CutSet]]]:
    """Per-part recording manifests for the RIR/noise package."""
    corpus_dir = Path(corpus_dir)
    if not corpus_dir.is_dir():
        raise AssertionError(f"No such directory: {corpus_dir}")
    if not parts:
        raise ValueError("No parts specified for manifest preparation.")
    if isinstance(parts, str):
        parts = [parts]

    manifests = {}
    for part in parts:
        if part not in _PART_DIRS:
            raise ValueError(f"Unknown RIR/noise part: {part}")
        audio_dir = corpus_dir / _PART_DIRS[part]
        if not audio_dir.is_dir():
            raise AssertionError(f"No such directory: {audio_dir}")
        manifests[part] = {"recordings": _collect(part, audio_dir)}

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for part, entry in manifests.items():
            for key, manifest in entry.items():
                manifest.to_file(output_dir / f"{part.replace('_', '-')}_{key}_all.jsonl.gz")
    return manifests
