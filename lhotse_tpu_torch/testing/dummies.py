"""
Factories that mass-produce small synthetic manifests for tests (copied
from ``lhotse_tpu/testing/dummies.py``: the same names, ids and payloads).
Waveform payloads come from the port's own WAV and FLAC encoders, byte for
byte the JAX package's.

Conventions baked into every factory:

* ids are zero-padded to four digits (``dummy-recording-0007``) so that
  lexicographic and numeric orderings agree in sorting tests;
* synthetic audio is a 1 kHz sine; in multi-channel sources channel ``c``
  is scaled by ``1/(c+1)`` so channel-selection bugs show up as amplitude
  mismatches rather than silent passes;
* "no data" variants point at obviously fake storage (an ``echo`` command
  source, a fixture path) — loading them is supposed to fail loudly.
"""
import contextlib
from io import BytesIO
from tempfile import NamedTemporaryFile
from typing import Dict, List, Optional, Type, Union

import numpy as np

from lhotse_tpu_torch.array import Array, TemporalArray
from lhotse_tpu_torch.audio import AudioSource, Recording
from lhotse_tpu_torch.cut import CutSet, MonoCut
from lhotse_tpu_torch.features import Features, FeatureSet
from lhotse_tpu_torch.features.io import MemoryRawWriter
from lhotse_tpu_torch.supervision import AlignmentItem, SupervisionSegment
from lhotse_tpu_torch.utils import compute_num_frames, compute_num_samples, fastcopy, not_ported

_SINE_HZ = 1000
_FAKE_NPY_KEY = "dbf9a0ec-f79d-4eb8-ae83-143a6d5de64d.npy"
_FAKE_NPY_DIR = "test/fixtures/dummy_feats/storage"


def _rid(n: int, multi: bool = False) -> str:
    stem = "dummy-multi-channel-recording" if multi else "dummy-recording"
    return f"{stem}-{n:04d}"


@contextlib.contextmanager
def as_lazy(manifest, suffix=".jsonl.gz"):
    """Round-trip an eager manifest through a temp file to get its lazy twin."""
    with NamedTemporaryFile(suffix=suffix) as f:
        manifest.to_file(f.name)
        f.flush()
        yield type(manifest).from_jsonl_lazy(f.name)


def _sine_block(num_samples: int, sampling_rate: int, num_channels: int) -> np.ndarray:
    """(num_channels, num_samples) float32 sine, channel c scaled by 1/(c+1)."""
    assert _SINE_HZ * 2 < sampling_rate, (
        f"Cannot synthesize a {_SINE_HZ} Hz test tone at {sampling_rate} Hz "
        f"sampling rate (Nyquist violation)."
    )
    t = np.arange(num_samples, dtype=np.float64) * (2 * np.pi * _SINE_HZ / sampling_rate)
    scale = 1.0 / np.arange(1, num_channels + 1, dtype=np.float64)
    return (scale[:, None] * np.sin(t)[None, :]).astype(np.float32)


def _encode(data: np.ndarray, sampling_rate: int, format: str) -> bytes:
    buf = BytesIO()
    if format == "flac":
        from lhotse_tpu_torch.audio.flacio import write_flac as enc
    else:
        from lhotse_tpu_torch.audio.wavio import write_wav as enc
    enc(buf, data, sampling_rate)
    return buf.getvalue()


def dummy_audio_source(
    num_samples: int = 16000, sampling_rate: int = 16000, channels: Optional[List[int]] = None,
    with_data: bool = False, format: str = "wav") -> AudioSource:
    channels = [0] if channels is None else channels
    if not with_data:
        # A command source that produces garbage: tests that only touch
        # metadata never notice; tests that decode fail immediately.
        return AudioSource(type="command", channels=channels, source='echo "dummy waveform"')
    wave = _sine_block(num_samples, sampling_rate, len(channels))
    return AudioSource(
        type="memory", channels=channels, source=_encode(wave, sampling_rate, format))


def dummy_recording(
    unique_id: int, duration: float = 1.0, sampling_rate: int = 16000, with_data: bool = False,
    source_format: str = "wav") -> Recording:
    n = compute_num_samples(duration, sampling_rate)
    src = dummy_audio_source(
        sampling_rate=sampling_rate, num_samples=n, with_data=with_data, format=source_format)
    return Recording(
        id=_rid(unique_id), sources=[src], sampling_rate=sampling_rate, num_samples=n,
        duration=duration)


def dummy_multi_channel_recording(
    unique_id: int, duration: float = 1.0, sampling_rate: int = 16000,
    channel_ids: Optional[List[int]] = None, source_per_channel: bool = False,
    with_data: bool = False) -> Recording:
    channel_ids = [0, 1] if channel_ids is None else channel_ids
    n = compute_num_samples(duration, sampling_rate)
    groups = [[c] for c in channel_ids] if source_per_channel else [channel_ids]
    return Recording(
        id=_rid(unique_id, multi=True),
        sources=[ dummy_audio_source( num_samples=n, sampling_rate=sampling_rate, channels=grp, with_data=with_data, ) for grp in groups ],
        sampling_rate=sampling_rate, num_samples=n, duration=duration)


def dummy_alignment(
    text: str = "irrelevant", start: float = 0.0, duration: float = 1.0,
) -> Dict[str, List[AlignmentItem]]:
    """Chop ``text`` into 3-char pseudo-subwords spread evenly over the span."""
    pieces = [text[i : i + 3] for i in range(0, len(text), 3)]
    step = duration / len(pieces)
    return {
        "subword": [
            AlignmentItem(symbol=p, start=start + k * step, duration=step)
            for k, p in enumerate(pieces)
        ]
    }


def dummy_supervision(
    unique_id: int, start: float = 0.0, duration: float = 1.0, channel: Union[int, List[int]] = 0,
    text: str = "irrelevant", alignment: Optional[Dict[str, List[AlignmentItem]]] = None,
) -> SupervisionSegment:
    return SupervisionSegment(
        id=f"dummy-segment-{unique_id:04d}", recording_id=_rid(unique_id), start=start,
        duration=duration, channel=channel, text=text, speaker="irrelevant", language="irrelevant",
        gender="irrelevant", custom={"custom_field": "irrelevant"},
        alignment=dummy_alignment() if alignment is None else alignment)


def _features_manifest(recording_id, channels, start, duration, **overrides) -> Features:
    base = dict(
        recording_id=recording_id, channels=channels, start=start, duration=duration, type="fbank",
        num_frames=100, num_features=23, frame_shift=0.01, sampling_rate=16000,
        storage_type="numpy_files", storage_path=_FAKE_NPY_DIR, storage_key=_FAKE_NPY_KEY)
    base.update(overrides)
    return Features(**base)


def dummy_features(
    unique_id: int, start: float = 0.0, duration: float = 1.0, with_data: bool = False) -> Features:
    if with_data:
        return dummy_in_memory_features(unique_id, start=start, duration=duration)
    return _features_manifest(_rid(unique_id), 0, start, duration)


def dummy_in_memory_features(
    unique_id: int, start: float = 0.0, duration: float = 1.0, sampling_rate: int = 16000,
    frame_shift: float = 0.01) -> Features:
    shape = (compute_num_frames(duration, frame_shift, sampling_rate), 23)
    payload = MemoryRawWriter().write("dummy-features", np.random.rand(*shape).astype(np.float32))
    return _features_manifest(
        _rid(unique_id), 0, start, duration, num_frames=shape[0], frame_shift=frame_shift,
        sampling_rate=sampling_rate, storage_type=MemoryRawWriter.name, storage_path="",
        storage_key=payload)


def dummy_multi_channel_features(
    unique_id: int, start: float = 0.0, duration: float = 1.0, channels: Optional[List[int]] = None,
) -> Features:
    return _features_manifest(
        _rid(unique_id, multi=True), [0, 1] if channels is None else channels, start, duration)


def dummy_array() -> Array:
    return MemoryRawWriter().store_array("vector-float32", np.random.rand(128).astype(np.float32))


def dummy_temporal_array(
    start: float = 0.0, num_frames: int = 100, num_features: int = 23, frame_shift: float = 0.01,
) -> TemporalArray:
    return MemoryRawWriter().store_array(
        key="temporal-array-float32",
        value=np.random.rand(num_frames, num_features).astype(np.float32), frame_shift=frame_shift,
        temporal_dim=0, start=start)


def dummy_temporal_array_uint8(
    start: float = 0.0, num_frames: int = 100, frame_shift: float = 0.01) -> TemporalArray:
    return MemoryRawWriter().store_array(
        "temporal-array-int8", np.random.randint(0, 255, num_frames, dtype=np.uint8),
        frame_shift=frame_shift, temporal_dim=0, start=start)


def dummy_cut(
    unique_id: int, start: float = 0.0, duration: float = 1.0, recording_duration: float = 1.0,
    recording: Recording = None, features: Features = None, supervisions=None,
    with_data: bool = False):
    custom = {"custom_attribute": "dummy-value", "custom_attribute_other": "dummy-value-other"}
    if with_data:
        custom["custom_embedding"] = dummy_array()
        custom["custom_features"] = dummy_temporal_array(start)
        custom["custom_recording"] = dummy_recording(unique_id, duration=duration, with_data=True)
        custom["custom_indexes"] = dummy_temporal_array_uint8(start=start)
    if recording is None:
        recording = dummy_recording(
            unique_id, duration=max(recording_duration, duration), with_data=with_data)
    return MonoCut(
        id=f"dummy-mono-cut-{unique_id:04d}", start=start, duration=duration, channel=0,
        recording=recording, features=features or dummy_features(unique_id, with_data=with_data),
        supervisions=[] if supervisions is None else supervisions, custom=custom)


def dummy_multi_cut(*args, **kwargs):
    """The JAX factory builds a ``MultiCut``, which the port does not have."""
    raise not_ported("MultiCut (dummy_multi_cut)")


# The port has no RecordingSet or SupervisionSet: DummyManifest makes the
# two Set types it has.
_BULK_BUILDERS = {
    FeatureSet: lambda i, with_data: dummy_features(i, with_data=with_data), CutSet: lambda i,
    with_data: dummy_cut( i, supervisions=[dummy_supervision(i)], with_data=with_data )}

_BULK_WRAPPERS = {FeatureSet: FeatureSet.from_features, CutSet: CutSet.from_cuts}


# noinspection PyPep8Naming
def DummyManifest(type_: Type, *, begin_id: int, end_id: int, with_data: bool = False):
    """Mass-produce a manifest set with ids ``begin_id..end_id`` (exclusive)."""
    try:
        make, wrap = _BULK_BUILDERS[type_], _BULK_WRAPPERS[type_]
    except KeyError:
        raise ValueError(
            f"DummyManifest cannot fabricate {type_!r}; choose one of "
            f"{sorted(t.__name__ for t in _BULK_BUILDERS)}"
        ) from None
    return wrap(make(i, with_data) for i in range(begin_id, end_id))


def remove_spaces_from_segment_text(segment):
    if segment.text is None:
        return segment
    return fastcopy(segment, text=segment.text.replace(" ", ""))
