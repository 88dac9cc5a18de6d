"""
Audio error types, the duration-mismatch tolerance and the error
suppression the loaders use (copied from ``lhotse_tpu/audio/utils.py``).
"""
from __future__ import annotations

import functools
import logging
import warnings
from contextlib import contextmanager
from dataclasses import asdict, dataclass
from typing import Callable, Optional

from lhotse_tpu_torch.utils import Seconds, fastcopy, suppress_and_warn

_TOLERANCE_DEFAULT: Seconds = 0.5
_tolerance_override: Optional[Seconds] = None


class NonPositiveEnergyError(ValueError):
    pass


class AudioLoadingError(Exception):
    pass


class DurationMismatchError(Exception):
    pass


_RECOVERABLE_AUDIO_ERRORS = (
    AudioLoadingError, DurationMismatchError, NonPositiveEnergyError, ConnectionResetError)


@dataclass
class VideoInfo:
    """Metadata about video content in a :class:`~lhotse_tpu_torch.audio.Recording`."""

    fps: float
    """Video frame rate (frames per second); float because some standard FPS are fractional (e.g. 59.94)."""

    num_frames: int
    """Number of video frames."""

    height: int
    """Height in pixels."""

    width: int
    """Width in pixels."""

    duration = property(lambda self: self.num_frames / self.fps)
    frame_length = property(lambda self: 1.0 / self.fps)

    def copy_with(self, **kwargs) -> "VideoInfo":
        return fastcopy(self, **kwargs)

    @classmethod
    def from_dict(cls, data: dict) -> "VideoInfo":
        return VideoInfo(**data)

    def to_dict(self) -> dict:
        return asdict(self)


def get_audio_duration_mismatch_tolerance() -> Seconds:
    """Retrieve the current audio duration mismatch tolerance in seconds."""
    if _tolerance_override is not None:
        return _tolerance_override
    return _TOLERANCE_DEFAULT


def set_audio_duration_mismatch_tolerance(delta: Seconds) -> None:
    """
    Override the global threshold for allowed audio duration mismatch between
    the manifest and the actual data. When there is a mismatch within
    tolerance, the audio is trimmed or padded (replicated) to match the
    manifest (reference: audio/utils.py:70-106).
    """
    global _tolerance_override
    previous = get_audio_duration_mismatch_tolerance()
    logging.info(
        "Overriding tolerance for audio duration mismatch. "
        f"Old threshold: {previous}s. New threshold: {delta}s."
    )
    if delta < _TOLERANCE_DEFAULT:
        warnings.warn(
            "The audio duration mismatch tolerance was set lower than the "
            f"default ({_TOLERANCE_DEFAULT}s); this may break some data "
            "augmentation transforms."
        )
    _tolerance_override = delta


@contextmanager
def suppress_audio_loading_errors(enabled: bool = True):
    """Suppress errors related to audio loading; emits a warning instead."""
    with suppress_and_warn(*_RECOVERABLE_AUDIO_ERRORS, enabled=enabled):
        yield


def null_result_on_audio_loading_error(func: Callable) -> Callable:
    """Decorator that makes a function return None when audio loading failed."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs) -> Optional:
        with suppress_audio_loading_errors():
            return func(*args, **kwargs)

    return wrapper
