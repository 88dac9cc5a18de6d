"""
Base class + registry for lazily-applied audio transforms (copied from
``lhotse_tpu/augmentation/transform.py``): dataclass transforms
auto-registered by class name, serialized into ``Recording.transforms`` as
``{"name": ..., "kwargs": ...}`` dicts; each transform defines
``__call__(samples, sampling_rate)`` and ``reverse_timestamps`` (maps
post-transform timestamps back to the source audio so only the needed
samples are read from disk).
"""
from __future__ import annotations

from dataclasses import asdict
from typing import Dict, Optional, Tuple, Type

import numpy as np

from lhotse_tpu_torch.utils import Seconds


class AudioTransform:
    """
    Base class for all audio transforms lazily applied by ``Recording`` while
    loading audio into memory. Usable as a function of
    ``(samples: np.ndarray, sampling_rate: int)``.

    Child classes are expected to be decorated with ``@dataclass`` and are
    automatically registered so that ``AudioTransform.from_dict()`` can find
    the right type by name.
    """

    KNOWN_TRANSFORMS: Dict[str, Type["AudioTransform"]] = {}

    def __init_subclass__(cls, **kwargs):
        if cls.__name__ not in AudioTransform.KNOWN_TRANSFORMS:
            AudioTransform.KNOWN_TRANSFORMS[cls.__name__] = cls
        super().__init_subclass__(**kwargs)

    @property
    def is_deterministic(self) -> bool:
        """
        True when ``__call__`` is a pure function of ``(samples,
        sampling_rate)`` and this transform's serialized parameters — i.e.
        repeated application yields bit-identical output. The decoded-audio
        LRU only memoizes post-transform waveforms for fully deterministic
        chains. Transforms that draw from stateful RNGs must override this.
        """
        return True

    @property
    def channel_wise(self) -> bool:
        """
        True when each output channel depends only on the same input
        channel, so a channel subset can be read before the transform runs.
        A transform that mixes or fans out channels (WPE, a multi-channel
        RIR) makes the recording read every channel first and pick the
        subset afterwards.
        """
        return True

    def to_dict(self) -> dict:
        data = asdict(self)
        return {"name": type(self).__name__, "kwargs": data}

    @staticmethod
    def from_dict(data: dict) -> "AudioTransform":
        assert (
            data["name"] in AudioTransform.KNOWN_TRANSFORMS
        ), f"Unknown transform type: {data['name']}"
        return AudioTransform.KNOWN_TRANSFORMS[data["name"]](**data["kwargs"])

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        raise NotImplementedError

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: int,
    ) -> Tuple[Seconds, Optional[Seconds]]:
        raise NotImplementedError
