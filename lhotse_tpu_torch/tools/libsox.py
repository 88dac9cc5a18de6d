"""
Optional sox-based resampling (copied from ``lhotse_tpu/tools/libsox.py``):
shells out to the ``sox`` binary, piping raw float32 in and out, and is
available only where a ``sox`` executable is on ``PATH``.
"""
import shutil
import subprocess
from typing import Optional

import numpy as np

__all__ = ["libsox_available", "libsox_rate"]


def libsox_available() -> bool:
    """True when a sox executable is on PATH."""
    return shutil.which("sox") is not None


def libsox_rate(
    samples: np.ndarray, sampling_rate: int, target_rate: int, quality: str = "v") -> np.ndarray:
    """
    Resample with sox's ``rate`` effect (very-high quality by default).

    :param samples: float waveform of shape (channels, num_samples) or
        (num_samples,).
    :param quality: one of sox rate qualities: q/l/m/h/v.
    :return: resampled float32 array with the same channel layout.
    """
    if not libsox_available():
        raise RuntimeError(
            "sox is not installed — install it or use the built-in sinc "
            "resampler (lhotse_tpu_torch.augmentation.resample)."
        )
    samples = np.asarray(samples, dtype=np.float32)
    squeeze = samples.ndim == 1
    if squeeze:
        samples = samples[None, :]
    channels = samples.shape[0]

    cmd = [
        "sox", "-t", "f32", "-r", str(sampling_rate), "-c", str(channels), "-", "-t", "f32", "-r",
        str(target_rate), "-c", str(channels), "-", "rate", f"-{quality}", str(target_rate)]
    proc = subprocess.run(
        cmd, input=np.ascontiguousarray(samples.T).tobytes(), capture_output=True, check=True)
    out = np.frombuffer(proc.stdout, dtype=np.float32)
    out = out.reshape(-1, channels).T
    return out[0] if squeeze else out
