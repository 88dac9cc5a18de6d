"""
Shar placeholder conversions (copied from ``lhotse_tpu/shar/utils.py``):
``to_shar_placeholder`` strips a manifest's storage before it is written,
``fill_shar_placeholder`` attaches the bytes read back from a tar member,
``fill_shar_placeholder_lazy`` a ``shar_ptr`` pointer to them instead.
"""
from pathlib import Path
from typing import Optional, TypeVar, Union

from lhotse_tpu_torch.array import Array, TemporalArray
from lhotse_tpu_torch.audio import AudioSource, Recording
from lhotse_tpu_torch.cut import Cut
from lhotse_tpu_torch.features import Features
from lhotse_tpu_torch.utils import Pathlike, compute_num_samples, fastcopy

Manifest = TypeVar("Manifest", Recording, Features, Array, TemporalArray)

_BLANK_STORAGE = dict(storage_type="shar", storage_path="", storage_key="")


def to_shar_placeholder(manifest: Manifest, cut: Optional[Cut] = None) -> Manifest:
    """Strip storage details, leaving a placeholder to be filled at read time."""
    if isinstance(manifest, Recording):
        span = manifest.duration if cut is None else cut.duration
        return fastcopy(
            manifest,
            # Collapse possibly-multiple sources into one 'shar' source.
            sources=[AudioSource(type="shar", channels=manifest.channel_ids, source="")],
            # Transforms were already executed when the audio was materialized.
            transforms=None,
            duration=span,
            num_samples=(
                manifest.num_samples
                if cut is None
                else compute_num_samples(span, manifest.sampling_rate)
            ),
        )
    if isinstance(manifest, Features):
        span = manifest.duration if cut is None else cut.duration
        return fastcopy(manifest, start=0, duration=span, **_BLANK_STORAGE)
    if isinstance(manifest, TemporalArray):
        return fastcopy(manifest, start=0, array=fastcopy(manifest.array, **_BLANK_STORAGE))
    if isinstance(manifest, Array):
        return fastcopy(manifest, **_BLANK_STORAGE)
    raise RuntimeError(f"Unexpected manifest type: {type(manifest)}")


def _unwrap_cut(fn):
    """Route Cut arguments to the named field's manifest before filling."""

    def wrapper(manifest, **kwargs):
        if isinstance(manifest, Cut):
            field = kwargs.get("field")
            assert field is not None, (
                "'field' argument must be provided when filling a Shar "
                "placeholder in a Cut."
            )
            manifest = getattr(manifest, field)
        return fn(manifest, **kwargs)

    return wrapper


def _array_memory_type(path: Path) -> str:
    if path.suffix == ".llc":
        return "memory_lilcom"
    if path.suffix == ".npy":
        return "memory_npy"
    raise RuntimeError(f"Unknown array/tensor format: {path}")


def _sole_source(recording: Recording) -> AudioSource:
    assert len(recording.sources) == 1, (
        "We expected a single (possibly multi-channel) AudioSource in Shar format."
    )
    return recording.sources[0]


@_unwrap_cut
def fill_shar_placeholder(
    manifest: Union[Cut, Recording, Features, Array, TemporalArray], data: bytes = None,
    tarpath: Pathlike = None, field: Optional[str] = None) -> None:
    """Attach in-memory ``data`` bytes to a shar placeholder manifest."""
    tarpath = Path(tarpath)
    if isinstance(manifest, Recording):
        src = _sole_source(manifest)
        src.type, src.source = "memory", data
    elif isinstance(manifest, (Features, Array)):
        manifest.storage_type = _array_memory_type(tarpath)
        manifest.storage_key = data
    elif isinstance(manifest, TemporalArray):
        manifest.array.storage_type = _array_memory_type(tarpath)
        manifest.array.storage_key = data
    else:
        raise RuntimeError(f"Unknown manifest type: {type(manifest).__name__}")


@_unwrap_cut
def fill_shar_placeholder_lazy(
    manifest: Union[Cut, Recording, Features, Array, TemporalArray], *, tar_path: Pathlike = None,
    offset: int = None, end_offset: int = None, field: Optional[str] = None) -> None:
    """
    Lazy variant: instead of inlining bytes, encode a Shar lazy pointer
    ``<tar_path>?o=<offset>&e=<end_offset>`` (a *payload* byte range from the
    .idx sidecar) so the data is fetched on demand. The payload format is
    sniffed from magic bytes at load time.
    """
    from lhotse_tpu_torch.shar.lazy_pointer import encode_pointer

    pointer = encode_pointer(str(tar_path), offset, end_offset)
    if isinstance(manifest, Recording):
        src = _sole_source(manifest)
        src.type, src.source = "shar_ptr", pointer
    elif isinstance(manifest, (Features, Array)):
        manifest.storage_type = "shar_ptr_array"
        manifest.storage_path = str(tar_path)
        manifest.storage_key = pointer
    elif isinstance(manifest, TemporalArray):
        manifest.array.storage_type = "shar_ptr_array"
        manifest.array.storage_path = str(tar_path)
        manifest.array.storage_key = pointer
    else:
        raise RuntimeError(f"Unknown manifest type: {type(manifest).__name__}")
