"""
Array tar writer (copied from ``lhotse_tpu/shar/writers/array.py``):
``numpy`` (lossless ``.npy``) or ``lilcom`` (the LTC1 codec of
:mod:`lhotse_tpu_torch.codecs.lilcom_codec`, ``.llc``).
"""
from io import BytesIO
from typing import Callable, Optional, Union

import numpy as np

from lhotse_tpu_torch.array import Array, TemporalArray
from lhotse_tpu_torch.features import Features
from lhotse_tpu_torch.shar.writers.common import TarBackedWriter


class ArrayTarWriter(TarBackedWriter):
    """
    Writes numpy arrays into auto-sharded tar archives; 'lilcom' compression
    suits log-domain features, 'numpy' is lossless.

    Example::

        >>> with ArrayTarWriter("dir/fbank.%06d.tar", shard_size=100, compression="lilcom") as w:
        ...     w.write("fbank1", fbank1_array, manifest)
    """

    def __init__(
        self, pattern: str, shard_size: Optional[int] = 1000, compression: str = "numpy",
        lilcom_tick_power: int = -5, shard_offset: int = 0,
        on_shard_complete: Optional[Callable[[str], None]] = None):
        if compression not in ("numpy", "lilcom"):
            raise AssertionError(f"Unknown compression: {compression} (supported: numpy, lilcom)")
        super().__init__(
            pattern, shard_size, shard_offset=shard_offset, on_shard_complete=on_shard_complete)
        self.compression = compression
        self.lilcom_tick_power = lilcom_tick_power

    def _encode(self, value: np.ndarray):
        """-> (extension, BytesIO) under the configured compression."""
        if self.compression == "lilcom":
            if not np.issubdtype(value.dtype, np.floating):
                raise AssertionError("Lilcom compression supports only floating-point arrays.")
            from lhotse_tpu_torch.codecs.lilcom_codec import compress

            return ".llc", BytesIO(compress(value, tick_power=self.lilcom_tick_power))
        stream = BytesIO()
        np.save(stream, value, allow_pickle=False)
        return ".npy", stream

    def write(
        self, key: str, value: np.ndarray, manifest: Union[Features, Array, TemporalArray]) -> None:
        ext, stream = self._encode(value)
        self.tar_writer.write(key + ext, stream)
        self._write_manifest(key, manifest)
