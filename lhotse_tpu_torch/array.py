"""
Array / TemporalArray: manifests for stored numpy arrays (copied from
``lhotse_tpu/array.py``). ``Array`` is a generic stored-ndarray pointer
(storage_type/path/key + shape); ``TemporalArray`` adds ``frame_shift``,
``temporal_dim`` and ``start``, enabling partial reads via
``load(start, duration)``; ``pad_array``.
"""
from __future__ import annotations

import decimal
import warnings
from dataclasses import asdict, dataclass
from math import isclose
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from lhotse_tpu_torch.utils import Pathlike, Seconds, fastcopy

_MEMORY_TYPES = ("memory_lilcom", "memory_writer")


def _open_storage(storage_type: str, storage_path):
    from lhotse_tpu_torch.features.io import get_reader

    return get_reader(storage_type)(storage_path)


def _memory_copy(arr: np.ndarray, lilcom: bool) -> "Array":
    """Re-store a loaded ndarray into an in-memory writer; returns the new
    Array manifest pointing at the serialized bytes."""
    from lhotse_tpu_torch.features.io import get_memory_writer

    compress = lilcom and np.issubdtype(arr.dtype, np.floating)
    writer = get_memory_writer("memory_lilcom" if compress else "memory_raw")()
    blob = writer.write("", arr)
    return Array(storage_type=writer.name, storage_path="", storage_key=blob, shape=list(arr.shape))


@dataclass
class Array:
    """
    Describes a numpy array stored somewhere (files, archive, memory, cloud);
    :meth:`load` abstracts away the storage mechanism via the FeaturesReader
    registry.
    """

    storage_type: str
    storage_path: str
    storage_key: str
    shape: List[int]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_in_memory(self) -> bool:
        from lhotse_tpu_torch.features.io import is_in_memory

        return is_in_memory(self.storage_type)

    @property
    def is_placeholder(self) -> bool:
        return self.storage_type == "shar"

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "Array":
        # Tolerate manifests that never stored a path (pure in-memory blobs).
        if "storage_path" not in data and {"storage_key", "storage_type"} <= set(data):
            data["storage_path"] = None
        return cls(**data)

    def load(self) -> np.ndarray:
        return _open_storage(self.storage_type, self.storage_path).read(self.storage_key)

    def with_path_prefix(self, path: Pathlike) -> "Array":
        return fastcopy(self, storage_path=str(Path(path) / self.storage_path))

    def copy_with(self, **kwargs) -> "Array":
        return fastcopy(self, **kwargs)

    def move_to_memory(self, lilcom: bool = False) -> "Array":
        if self.storage_type in _MEMORY_TYPES:
            return self
        moved = _memory_copy(self.load(), lilcom)
        return fastcopy(moved, shape=self.shape)

    def __repr__(self):
        key = self.storage_key if isinstance(self.storage_key, str) else "<binary-data>"
        return (
            f"Array(storage_type='{self.storage_type}', "
            f"storage_path='{self.storage_path}', "
            f"storage_key='{key}', shape={self.shape})"
        )


@dataclass
class TemporalArray:
    """
    Array with a temporal dimension: knows its ``frame_shift``,
    ``temporal_dim``, and ``start``, enabling partial reads of sub-segments
    when the storage supports them.
    """

    array: Array
    temporal_dim: int
    frame_shift: Seconds
    start: Seconds

    # Storage concerns delegate to the wrapped Array; temporal extent is
    # derived from frame_shift x num_frames.

    shape = property(lambda self: self.array.shape)
    ndim = property(lambda self: self.array.ndim)
    is_in_memory = property(lambda self: self.array.is_in_memory)
    is_placeholder = property(lambda self: self.array.is_placeholder)
    num_frames = property(lambda self: self.shape[self.temporal_dim])
    duration = property(lambda self: self.num_frames * self.frame_shift)
    end = property(lambda self: self.start + self.duration)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "TemporalArray":
        fields = dict(data)
        inner = Array.from_dict(fields.pop("array"))
        return cls(array=inner, **fields)

    def _frame_window(self, start: Optional[Seconds], duration: Optional[Seconds]):
        """(left, right) frame offsets along temporal_dim for a partial read."""
        if start is None:
            start = self.start
        if start < self.start - 1e-5:
            raise ValueError(
                f"Cannot load array starting from {start}s. "
                f"The available range is ({self.start}, {self.end}) seconds."
            )
        max_frames = self.num_frames
        left = (
            0
            if isclose(start, self.start)
            else seconds_to_frames(
                start - self.start, frame_shift=self.frame_shift, max_index=max_frames
            )
        )
        right = None
        if duration is not None:
            right = left + seconds_to_frames(
                duration, frame_shift=self.frame_shift, max_index=max_frames)
        return left, right

    def load(
        self, start: Optional[Seconds] = None, duration: Optional[Seconds] = None) -> np.ndarray:
        """Load the array, optionally partially along ``temporal_dim``."""
        left, right = self._frame_window(start, duration)
        storage = _open_storage(self.array.storage_type, self.array.storage_path)
        return storage.read(
            self.array.storage_key, left_offset_frames=left, right_offset_frames=right)

    def with_path_prefix(self, path: Pathlike) -> "TemporalArray":
        return fastcopy(self, array=self.array.with_path_prefix(path))

    def copy_with(self, **kwargs) -> "TemporalArray":
        return fastcopy(self, **kwargs)

    def move_to_memory(
        self, start: Seconds = 0, duration: Optional[Seconds] = None, lilcom: bool = False,
    ) -> "TemporalArray":
        if self.array.storage_type in _MEMORY_TYPES:
            return self
        moved = TemporalArray(
            array=_memory_copy(self.load(start=start, duration=duration), lilcom),
            temporal_dim=self.temporal_dim,
            frame_shift=self.frame_shift,
            # The manifest now describes the moved subset; it starts at 0.
            start=0.0,
        )
        if moved.shape == [0]:
            warnings.warn(
                "A TemporalArray with shape [0] encountered. If unexpected with "
                "long-recording data, make sure the 'start' attribute is set properly."
            )
        return moved


def seconds_to_frames(
    duration: Seconds, frame_shift: Seconds, max_index: Optional[int] = None) -> int:
    """
    Convert a time quantity in seconds to a frame index, limited to the array
    shape when ``max_index`` is given (reference: array.py:330, 8-digit
    rounding then HALF_UP quantization).
    """
    assert duration >= 0
    quotient = decimal.Decimal(round(duration / frame_shift, ndigits=8))
    index = int(quotient.quantize(0, rounding=decimal.ROUND_HALF_UP))
    return index if max_index is None else min(index, max_index)


def deserialize_array(raw_data: dict) -> Union[Array, TemporalArray]:
    """Dispatch Array vs TemporalArray during deserialization."""
    if "array" in raw_data:
        return TemporalArray.from_dict(raw_data)
    if "shape" in raw_data:
        return Array.from_dict(raw_data)
    raise ValueError(f"Cannot deserialize array from: {raw_data}")


def pad_array(
    array: np.ndarray, temporal_dim: int, frame_shift: Seconds, offset: Seconds,
    padded_duration: Seconds, pad_value: Union[int, float]) -> np.ndarray:
    """
    Pad an array along its temporal dim, guided by durations: ``offset``
    seconds of padding in front, total ``padded_duration`` after padding.
    """
    have = array.shape[temporal_dim]
    want = seconds_to_frames(padded_duration, frame_shift=frame_shift)
    missing = want - have
    assert missing >= 0, (
        f"Invalid argument values for pad_array: array with shape {array.shape} cannot be "
        f"padded to padded_duration of {padded_duration} (total {want} frames "
        f"under frame_shift={frame_shift})."
    )
    if missing == 0:
        return array
    before = seconds_to_frames(offset, frame_shift=frame_shift)
    after = missing - before
    if after == -1:
        # Off-by-one frame edge case from duration rounding.
        before, after = before - 1, 0
    assert after >= 0, "Something went wrong..."
    widths = [(0, 0)] * array.ndim
    widths[temporal_dim] = (before, after)
    return np.pad(array, pad_width=widths, mode="constant", constant_values=pad_value)
