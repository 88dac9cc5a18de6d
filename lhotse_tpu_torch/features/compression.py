"""
Chunked lossy compression of feature matrices (copied from
``lhotse_tpu/features/compression.py``): split a float32 matrix into fixed-size chunks along the time axis and compress
each chunk independently (tick_power=-5 ⇒ quantization to multiples of 2^-5),
enabling partial reads per chunk.
"""
from typing import List

import numpy as np

from lhotse_tpu_torch.codecs import compress


def lilcom_compress_chunked(
    data: np.ndarray, tick_power: int = -5, do_regression: bool = True, chunk_size: int = 100,
    temporal_dim: int = 0) -> List[bytes]:
    assert temporal_dim < data.ndim
    num_frames = data.shape[temporal_dim]
    return [
        compress(
            data[begin : begin + chunk_size],
            tick_power=tick_power,
            do_regression=do_regression,
        )
        for begin in range(0, num_frames, chunk_size)
    ]
