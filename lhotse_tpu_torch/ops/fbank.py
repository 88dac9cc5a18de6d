"""
Kaldi-compatible feature extraction as PyTorch ops (port of
``lhotse_tpu/ops/fbank.py``).

The numpy builders (windows, mel banks, DCT, lifter and the folded
preprocessing+DFT analysis matrices) are copies of the JAX package's; the
tests hold each copy equal to its original with ``np.array_equal``. The
compute functions take and return ``torch.Tensor`` s.

Everything after framing is linear until the squared magnitude, so DC
removal → pre-emphasis → window → real DFT fold into two matrices ``Mc``/``Ms``
of shape (frame_samples, num_bins): ``powspec = (F @ Mc)^2 + (F @ Ms)^2``.

float32 matrix products must run in IEEE fp32 for the 1e-4 parity budget.
That is PyTorch's default on CUDA (``torch.backends.cuda.matmul.allow_tf32``
is False); this module does not change it.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

EPSILON = 1e-10
FLT_EPS = float(np.finfo(np.float32).eps)

HAMMING = "hamming"
HANNING = "hanning"
POVEY = "povey"
RECTANGULAR = "rectangular"
BLACKMAN = "blackman"


def available_windows() -> List[str]:
    return [HAMMING, HANNING, POVEY, RECTANGULAR, BLACKMAN]


def next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


def lin2mel(x):
    return 1127.0 * np.log(1 + np.asarray(x, dtype=np.float64) / 700)


def mel2lin(x):
    return 700 * (np.exp(np.asarray(x, dtype=np.float64) / 1127.0) - 1)


def create_frame_window(window_size: int, window_type: str = POVEY, blackman_coeff=0.42) -> np.ndarray:
    """Window function of the given type/size (float64). The 'povey' window is
    hann^0.85; all windows are periodic=False (symmetric)."""
    n = np.arange(window_size, dtype=np.float64)
    if window_type == HANNING:
        return 0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))
    if window_type == HAMMING:
        return 0.54 - 0.46 * np.cos(2 * np.pi * n / (window_size - 1))
    if window_type == POVEY:
        return (0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))) ** 0.85
    if window_type == RECTANGULAR:
        return np.ones(window_size, dtype=np.float64)
    if window_type == BLACKMAN:
        a = 2 * np.pi / window_size
        return (blackman_coeff - 0.5 * np.cos(a * n) + (0.5 - blackman_coeff) * np.cos(2 * a * n))
    raise ValueError(f"Invalid window type: {window_type}")


def get_mel_banks(
    num_bins: int, window_length_padded: int, sample_freq: float, low_freq: float, high_freq: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Kaldi/torchaudio-compatible triangular mel filterbank of shape
    (num_bins, num_fft_bins) where num_fft_bins = window_length_padded / 2
    (the nyquist bin is excluded and later zero-padded).
    """
    assert num_bins > 3, "Must have at least 3 mel bins"
    assert window_length_padded % 2 == 0
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq += nyquist
    assert (
        (0.0 <= low_freq < nyquist) and (0.0 < high_freq <= nyquist) and (low_freq < high_freq)
    ), f"Bad frequency range: low={low_freq} high={high_freq} nyquist={nyquist}"

    fft_bin_width = sample_freq / window_length_padded
    mel_low = lin2mel(low_freq)
    mel_high = lin2mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta
    center_freqs = mel2lin(center_mel)

    mel = lin2mel(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    bins = np.maximum(0.0, np.minimum(up_slope, down_slope))
    return bins, center_freqs.squeeze(-1)


def create_mel_scale(
    num_filters: int, fft_length: int, sampling_rate: int, low_freq: float = 0,
    high_freq: Optional[float] = None, norm_filters: bool = True) -> np.ndarray:
    """Alternative (non-torchaudio) mel bank of shape (fft_bins+1, num_filters)."""
    if high_freq is None or high_freq == 0:
        high_freq = sampling_rate / 2
    if high_freq < 0:
        high_freq = sampling_rate / 2 + high_freq
    mel_low = lin2mel(low_freq)
    mel_high = lin2mel(high_freq)
    melfc = np.linspace(mel_low, mel_high, num_filters + 2)
    mels = lin2mel(np.linspace(0, sampling_rate, fft_length))
    B = np.zeros((fft_length // 2 + 1, num_filters), dtype=np.float64)
    for k in range(num_filters):
        left_mel, center_mel, right_mel = melfc[k], melfc[k + 1], melfc[k + 2]
        for j in range(fft_length // 2):
            mel_j = mels[j]
            if left_mel < mel_j < right_mel:
                if mel_j <= center_mel:
                    B[j, k] = (mel_j - left_mel) / (center_mel - left_mel)
                else:
                    B[j, k] = (right_mel - mel_j) / (right_mel - center_mel)
    if norm_filters:
        B = B / np.sum(B, axis=0, keepdims=True)
    return B


def make_dct_matrix(num_ceps: int, num_filters: int) -> np.ndarray:
    """Orthogonal DCT-II matrix (num_filters, num_ceps)."""
    n = np.arange(float(num_filters))[:, None]
    k = np.arange(float(num_ceps))[None, :]
    dct = np.cos(math.pi / float(num_filters) * (n + 0.5) * k)
    dct[:, 0] *= 1.0 / math.sqrt(2.0)
    dct *= math.sqrt(2.0 / float(num_filters))
    return dct


def make_lifter(num_ceps: int, Q: int) -> np.ndarray:
    """Sin lifter vector."""
    if Q == 0:
        return np.ones(num_ceps, dtype=np.float64)
    return 1 + 0.5 * Q * np.sin(math.pi * np.arange(num_ceps, dtype=np.float64) / Q)


def frame_preprocessing_matrix(
    frame_samples: int, remove_dc_offset: bool = True, preemph_coeff: float = 0.97,
    window: Optional[np.ndarray] = None) -> np.ndarray:
    """
    The per-frame linear preprocessing as one (frame_samples, frame_samples)
    matrix L such that ``processed_frame = frame @ L``:
    DC removal (I - 11^T/N), pre-emphasis with replicate left pad
    (y[n] = x[n] - c*x[n-1], y[0] = x[0] - c*x[0]), and windowing diag(w).
    """
    N = frame_samples
    L = np.eye(N, dtype=np.float64)
    if remove_dc_offset:
        L = L - np.full((N, N), 1.0 / N)
    if preemph_coeff != 0.0:
        P = np.eye(N, dtype=np.float64)
        P[0, 0] = 1.0 - preemph_coeff
        idx = np.arange(1, N)
        Pm = np.zeros((N, N), dtype=np.float64)
        Pm[idx - 1, idx] = -preemph_coeff
        P = np.eye(N, dtype=np.float64) + Pm
        P[0, 0] = 1.0 - preemph_coeff
        L = L @ P
    if window is not None:
        L = L * window[None, :]
    return L


@lru_cache(maxsize=32)
def dft_analysis_matrices(
    frame_samples: int, fft_length: int, window_type: str = POVEY, remove_dc_offset: bool = True,
    preemph_coeff: float = 0.97) -> Tuple[np.ndarray, np.ndarray]:
    """
    Precompute Mc, Ms of shape (frame_samples, fft_length//2 + 1) folding the
    full linear frame chain with the real DFT:
    ``X_re = F @ Mc``, ``X_im = F @ Ms`` for raw frames F.
    """
    window = create_frame_window(frame_samples, window_type=window_type)
    L = frame_preprocessing_matrix(
        frame_samples, remove_dc_offset=remove_dc_offset, preemph_coeff=preemph_coeff,
        window=window)
    n = np.arange(frame_samples, dtype=np.float64)[:, None]
    k = np.arange(fft_length // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    C = np.cos(ang)
    S = -np.sin(ang)
    Mc = (L @ C).astype(np.float32)
    Ms = (L @ S).astype(np.float32)
    return Mc, Ms


@lru_cache(maxsize=None)
def raw_dft_matrices(frame_samples: int, fft_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """
    Plain real-DFT analysis matrices (no preprocessing folded), for frames
    that were already DC-removed/pre-emphasized/windowed (and possibly
    zero-padded): ``X_re = F @ C``, ``X_im = F @ S`` with shapes
    (frame_samples, fft_length//2 + 1).
    """
    n = np.arange(frame_samples, dtype=np.float64)[:, None]
    k = np.arange(fft_length // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    C = np.cos(ang).astype(np.float32)
    S = (-np.sin(ang)).astype(np.float32)
    return C, S


def compute_num_frames_snip(num_samples: int, length: int, shift: int) -> int:
    if num_samples < length:
        return 0
    return 1 + (num_samples - length) // shift


def compute_num_frames_pad(num_samples: int, shift: int) -> int:
    return (num_samples + shift // 2) // shift


#################################################
# PyTorch compute functions
#################################################


def symmetric_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """numpy ``mode="symmetric"`` padding of the last axis: the mirror image
    includes the edge sample (``F.pad(mode="reflect")`` leaves it out), and a
    pad longer than the signal keeps mirroring, as numpy does."""
    n = x.shape[-1]
    if n == 0 and (left > 0 or right > 0):
        raise ValueError("cannot pad an empty signal symmetrically")
    while left > 0 or right > 0:
        # Each round mirrors at most n samples at each end; the next round
        # mirrors the chunk just added, which continues numpy's extension.
        lc, rc = min(left, n), min(right, n)
        x = torch.cat([x[..., :lc].flip(-1), x, x[..., x.shape[-1] - rc:].flip(-1)], dim=-1)
        left -= lc
        right -= rc
    return x


def frame_signal(x: torch.Tensor, frame_samples: int, frame_shift_samples: int,
                 snip_edges: bool = False) -> torch.Tensor:
    """
    Partition (B, N) waveforms into overlapping frames (B, T, frame_samples),
    as a strided view from ``Tensor.unfold``. snip_edges=False applies the
    symmetric edge padding of the JAX package's ``frame_signal``.
    """
    B, N = x.shape
    if snip_edges:
        num_frames = compute_num_frames_snip(N, frame_samples, frame_shift_samples)
        padded = x
    else:
        num_frames = compute_num_frames_pad(N, frame_shift_samples)
        new_num_samples = (num_frames - 1) * frame_shift_samples + frame_samples
        npad = new_num_samples - N
        npad_left = (frame_samples - frame_shift_samples) // 2
        npad_right = npad - npad_left
        if npad_right >= 0:
            padded = symmetric_pad(x, npad_left, npad_right)
        else:
            padded = symmetric_pad(x, npad_left, 0)[:, :new_num_samples]
    if num_frames <= 0:
        return x.new_zeros((B, 0, frame_samples))
    return padded.unfold(-1, frame_samples, frame_shift_samples)[:, :num_frames]


def frame_log_energy(frames: torch.Tensor, energy_floor: float = EPSILON) -> torch.Tensor:
    """Raw log energy per frame (after DC removal): log(sum(x^2) + 1e-15),
    floored at log(energy_floor)."""
    log_energy = torch.log(torch.sum(frames**2, dim=-1) + 1e-15)
    if energy_floor > 0.0:
        log_energy = torch.clamp_min(log_energy, math.log(energy_floor))
    return log_energy


def power_spectrum_gemm(frames: torch.Tensor, Mc: torch.Tensor, Ms: torch.Tensor,
                        use_fft_mag: bool = False) -> torch.Tensor:
    """Power (or magnitude) spectrum via the folded-GEMM DFT formulation."""
    re = torch.matmul(frames, Mc)
    im = torch.matmul(frames, Ms)
    pow_spec = re * re + im * im
    if use_fft_mag:
        pow_spec = torch.sqrt(pow_spec)
    return pow_spec


def power_spectrum_rfft(
    frames: torch.Tensor, fft_length: int, window: torch.Tensor, remove_dc_offset: bool = True,
    preemph_coeff: float = 0.97, use_fft_mag: bool = False) -> torch.Tensor:
    """Explicit path: per-frame ops + rFFT (for cross-validation)."""
    x = frames
    if remove_dc_offset:
        x = x - torch.mean(x, dim=-1, keepdim=True)
    if preemph_coeff != 0.0:
        prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - preemph_coeff * prev
    x = x * window
    X = torch.fft.rfft(x, n=fft_length, dim=-1)
    return X.abs() ** 2 if not use_fft_mag else X.abs()


def mel_fbank_from_power(pow_spec: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """Mel GEMM + eps-floored log."""
    return torch.log(torch.clamp_min(torch.matmul(pow_spec, fb), FLT_EPS))


def mfcc_from_logmel(logmel: torch.Tensor, dct: torch.Tensor,
                     lifter: Optional[torch.Tensor]) -> torch.Tensor:
    out = torch.matmul(logmel, dct)
    if lifter is not None:
        out = out * lifter
    return out
