"""
Recipe helpers (copied from ``lhotse_tpu/recipes/utils.py``): reading
manifests cached by an earlier run, checking that they exist, and the
common recipe tail ``finalize_manifests``.
"""
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Union

from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.features import FeatureSet
from lhotse_tpu_torch.serialization import load_manifest
from lhotse_tpu_torch.supervision import SupervisionSet
from lhotse_tpu_torch.utils import Pathlike

DEFAULT_DETECTED_MANIFEST_TYPES = ("recordings", "supervisions")

TYPES_TO_CLASSES = {
    "recordings": RecordingSet, "supervisions": SupervisionSet, "features": FeatureSet,
    "cuts": CutSet, "cutset": CutSet}


def read_manifests_if_cached(
    dataset_parts: Optional[Sequence[str]], output_dir: Optional[Pathlike], prefix: str = "",
    suffix: Optional[str] = "jsonl.gz", types: Iterable[str] = DEFAULT_DETECTED_MANIFEST_TYPES,
    lazy: bool = False) -> Optional[Dict[str, Dict[str, Union[RecordingSet, SupervisionSet]]]]:
    """
    Load manifests matching ``output_dir / f'{prefix}_{type}_{part}.{suffix}'``
    from disk when they exist — skips re-running data preparation.
    """
    if isinstance(dataset_parts, str):
        dataset_parts = [dataset_parts]
    if output_dir is None:
        return None
    if prefix and not prefix.endswith("_"):
        prefix = f"{prefix}_"
    if suffix.startswith("."):
        suffix = suffix[1:]
    if lazy and not suffix.startswith("jsonl"):
        raise ValueError(f"Only JSONL manifests can be opened lazily (got suffix: '{suffix}')")
    manifests = defaultdict(dict)
    output_dir = Path(output_dir)
    for part in dataset_parts:
        for manifest in types:
            path = output_dir / f"{prefix}{manifest}_{part}.{suffix}"
            if not path.is_file():
                continue
            if lazy:
                manifests[part][manifest] = TYPES_TO_CLASSES[manifest].from_jsonl_lazy(path)
            else:
                # The type is known from the filename, so pass it explicitly:
                # content-based detection cannot classify a legitimately empty
                # manifest (e.g. an absent split) and would raise on it.
                manifests[part][manifest] = load_manifest(
                    path, manifest_cls=TYPES_TO_CLASSES.get(manifest))
    return dict(manifests)


def manifests_exist(
    part: str, output_dir: Optional[Pathlike],
    types: Iterable[str] = DEFAULT_DETECTED_MANIFEST_TYPES, prefix: str = "",
    suffix: str = "jsonl.gz") -> bool:
    if output_dir is None:
        return False
    if prefix and not prefix.endswith("_"):
        prefix = f"{prefix}_"
    if suffix.startswith("."):
        suffix = suffix[1:]
    output_dir = Path(output_dir)
    for name in types:
        path = output_dir / f"{prefix}{name}_{part}.{suffix}"
        if not path.is_file():
            return False
    return True


def finalize_manifests(
    recordings, supervisions, *, output_dir: Optional[Pathlike] = None, prefix: str = "",
    part: str = "all") -> Dict[str, Union[RecordingSet, SupervisionSet]]:
    """
    The common recipe tail: fix + validate the pair, optionally persist it as
    ``{prefix}_recordings_{part}.jsonl.gz`` (same for supervisions), and
    return the ``{"recordings": ..., "supervisions": ...}`` dict.
    """
    from lhotse_tpu_torch.qa import fix_manifests, validate_recordings_and_supervisions

    if not isinstance(recordings, RecordingSet):
        recordings = RecordingSet.from_recordings(recordings)
    if not isinstance(supervisions, SupervisionSet):
        supervisions = SupervisionSet.from_segments(supervisions)
    if len(recordings) > 0:  # an absent split legitimately yields empty manifests
        recordings, supervisions = fix_manifests(recordings, supervisions)
        validate_recordings_and_supervisions(recordings, supervisions)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{prefix}_" if prefix and not prefix.endswith("_") else prefix
        recordings.to_file(output_dir / f"{tag}recordings_{part}.jsonl.gz")
        supervisions.to_file(output_dir / f"{tag}supervisions_{part}.jsonl.gz")
    return {"recordings": recordings, "supervisions": supervisions}
