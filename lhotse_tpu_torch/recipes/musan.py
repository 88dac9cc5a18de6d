"""
MUSAN corpus recipe (openslr/17; copied from ``lhotse_tpu/recipes/musan.py``):
music, speech and noise recordings used for augmentation, as the noise
sources of ``CutMix`` and the noise pool of ``OnDeviceAugmenter``.

The music part gets supervisions carrying the genre, vocals and musician
annotations of its per-directory ``ANNOTATIONS`` files; speech and noise
are recordings only. ``download_musan`` is not ported: it needs the
network.
"""
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

from lhotse_tpu_torch.audio import Recording, RecordingSet
from lhotse_tpu_torch.qa import validate, validate_recordings_and_supervisions
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import Pathlike


def _scan_recordings(part_dir: Path) -> RecordingSet:
    return RecordingSet.from_recordings(
        Recording.from_file(p) for p in sorted(part_dir.rglob("*.wav"))
    )


def _read_annotations(path: Path, max_fields: int) -> Iterable[List[str]]:
    with open(path) as f:
        for line in f:
            fields = line.strip().split()
            if fields:
                yield fields[:max_fields]


def prepare_music(
    corpus_dir: Path, use_vocals: bool = True
) -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """Music-part manifests with genre/vocals/musician supervisions."""
    corpus_dir = Path(corpus_dir)
    music_dir = corpus_dir / "music"
    recordings = _scan_recordings(music_dir)
    supervisions = SupervisionSet.from_segments(
        SupervisionSegment(
            id=utt, recording_id=utt, start=0, duration=recordings.duration(utt),
            speaker=musician, custom={"genres": genres.split(","), "vocals": vocals == "Y"})
        for ann_file in sorted(music_dir.rglob("ANNOTATIONS"))
        for utt, genres, vocals, musician in _read_annotations(ann_file, max_fields=4))
    if not use_vocals:
        supervisions = supervisions.filter(lambda s: s.custom["vocals"] is False)
    return {"recordings": recordings, "supervisions": supervisions}


def prepare_musan(
    corpus_dir: Pathlike, output_dir: Optional[Pathlike] = None,
    parts: Sequence[str] = ("music", "speech", "noise"), use_vocals: bool = True,
) -> Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]:
    """
    Prepare per-part manifests: ``music`` with annotation supervisions,
    ``speech``/``noise`` recordings-only.
    """
    corpus_dir = Path(corpus_dir)
    assert corpus_dir.is_dir(), f"No such directory: {corpus_dir}"
    if isinstance(parts, str):
        parts = [parts]
    if not parts:
        raise ValueError("No MUSAN parts specified for manifest preparation.")

    manifests: Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]] = {}
    if "music" in parts:
        manifests["music"] = prepare_music(corpus_dir, use_vocals=use_vocals)
        validate_recordings_and_supervisions(**manifests["music"])
    for part in ("speech", "noise"):
        if part in parts:
            manifests[part] = {"recordings": _scan_recordings(corpus_dir / part)}
            validate(manifests[part]["recordings"])

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for part, part_manifests in manifests.items():
            for key, manifest in part_manifests.items():
                manifest.to_file(output_dir / f"musan_{key}_{part}.jsonl.gz")
    return manifests
