"""
Batched on-device sinc resampler (port of ``lhotse_tpu/ops/resample.py``,
with the polyphase kernel builder of ``lhotse_tpu/augmentation/resample.py``).

The ``(n_phases, K)`` windowed-sinc kernel is built in numpy as the JAX
package builds it, and the resampling is one strided ``F.conv1d``: stride
``orig_freq`` (after gcd reduction), the ``n_phases`` filters as output
channels, so a whole ``(B, T)`` bucket resamples in one call.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F


def _sinc_resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99,
    beta: Optional[float] = None, resampling_method: str = "sinc_interp_hann",
) -> Tuple[np.ndarray, int]:
    """Build the polyphase kernel (new_freq, 2*width + orig_freq) and width."""
    assert int(orig_freq) == orig_freq and int(new_freq) == new_freq
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig_freq = int(orig_freq) // gcd
    new_freq = int(new_freq) // gcd

    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    if resampling_method == "sinc_interp_hann":
        window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    elif resampling_method == "sinc_interp_kaiser":
        if beta is None:
            beta = 14.769656459379492
        window = np.i0(
            beta * np.sqrt(np.maximum(1 - (t / lowpass_filter_width) ** 2, 0.0))
        ) / np.i0(beta)
    else:
        raise ValueError(f"Invalid resampling method: {resampling_method}")

    t *= math.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * scale
    return kernels.astype(np.float32), width


@lru_cache(maxsize=None)
def get_sinc_resample_kernel(
    orig_freq: int, new_freq: int, lowpass_filter_width: int = 6, rolloff: float = 0.99,
) -> Tuple[np.ndarray, int]:
    return _sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)


@lru_cache(maxsize=None)
def _conv_weight(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float,
                 device: torch.device) -> torch.Tensor:
    kernel, _ = get_sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    return torch.as_tensor(kernel, device=device)[:, None, :]  # (n_phases, 1, K)


def resampled_num_samples(num_samples, orig_freq: int, new_freq: int):
    """
    Output length of :func:`sinc_resample` for an input of ``num_samples``:
    ``ceil(new * n / orig)`` after gcd reduction. Works on Python ints and on
    integer arrays or tensors (per-item lens of a padded batch).
    """
    gcd = math.gcd(int(orig_freq), int(new_freq))
    o = int(orig_freq) // gcd
    n = int(new_freq) // gcd
    if isinstance(num_samples, (int, np.integer)):
        return int(math.ceil(n * num_samples / o))
    return (num_samples * n + o - 1) // o


def sinc_resample(
    waveform: torch.Tensor, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """
    Resample ``waveform`` of shape ``(..., time)`` from ``orig_freq`` to
    ``new_freq`` on its device. For padded batches, per-item output lengths
    are ``resampled_num_samples(lens, orig, new)``; samples beyond an item's
    valid length are garbage-in/garbage-out exactly like the padding itself.
    """
    orig_freq, new_freq = int(orig_freq), int(new_freq)
    if orig_freq == new_freq:
        return waveform
    o = orig_freq // math.gcd(orig_freq, new_freq)
    _, width = get_sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)
    weight = _conv_weight(
        orig_freq, new_freq, int(lowpass_filter_width), float(rolloff), waveform.device)
    shape = waveform.shape
    x = waveform.reshape(-1, shape[-1]).to(torch.float32)
    x = F.pad(x, (width, width + o))
    # cuDNN runs float32 convolutions in TF32 by default, which keeps ~3
    # decimal digits and breaks the 1e-4 feature budget; this conv must be
    # IEEE fp32 like the JAX package's. The flags are restored on exit.
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        # out[b, p, j] = sum_k x[b, j*o + k] * kernel[p, k]
        out = F.conv1d(x[:, None, :], weight, stride=o)
    out = out.transpose(1, 2).reshape(x.shape[0], -1)
    target = resampled_num_samples(shape[-1], orig_freq, new_freq)
    return out[:, :target].reshape(shape[:-1] + (target,))


def speed_perturb(waveform: torch.Tensor, factor: float, sampling_rate: int = 16000) -> torch.Tensor:
    """
    Batched on-device speed perturbation (sox ``speed`` semantics):
    reinterpret the signal at ``rate * factor`` and resample back to
    ``rate``, shortening (factor > 1) or stretching (factor < 1) both
    duration and pitch. Returns the resampled ``(..., new_time)`` tensor.
    """
    return sinc_resample(waveform, orig_freq=round(sampling_rate * factor), new_freq=sampling_rate)
