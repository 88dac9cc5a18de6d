"""
Audio tar writer (copied from ``lhotse_tpu/shar/writers/audio.py``):
``flac``, ``wav``, ``original``, and ``mp3`` and ``opus`` through the
system codec libraries, all through the port's ``save_audio``.
"""
from io import BytesIO
from typing import Callable, Optional

import numpy as np

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.audio.backend import save_audio
from lhotse_tpu_torch.shar.writers.common import TarBackedWriter


class AudioTarWriter(TarBackedWriter):
    """
    Writes audio arrays into auto-sharded tar archives using audio-specific
    compression ('wav', 'flac', 'mp3', 'opus', or 'original').

    Example::

        >>> with AudioTarWriter("some_dir/audio.%06d.tar", shard_size=100, format="flac") as w:
        ...     w.write("audio1", audio1_array, 16000, manifest)
    """

    def __init__(
        self, pattern: str, shard_size: Optional[int] = 1000, format: str = "flac",
        shard_offset: int = 0, on_shard_complete: Optional[Callable[[str], None]] = None):
        super().__init__(
            pattern, shard_size, shard_offset=shard_offset, on_shard_complete=on_shard_complete)
        self.format = format

    def resolve_format(self, original_format: Optional[str]) -> str:
        if self.format != "original":
            return self.format
        # 'original' keeps the source codec, defaulting to wav when unknown.
        return original_format if original_format is not None else "wav"

    def write(
        self, key: str, value: np.ndarray, sampling_rate: int, manifest: Recording,
        original_format: Optional[str] = None) -> None:
        stream = BytesIO()
        save_audio(
            dest=stream, src=value, sampling_rate=sampling_rate,
            format=self.resolve_format(original_format))
        self.tar_writer.write(f"{key}.{self.format}", stream)
        self._write_manifest(key, manifest)
