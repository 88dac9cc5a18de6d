"""
Batched WPE dereverberation on the device (port of
``lhotse_tpu/ops/wpe.py``).

The JAX package's algorithm and constants (blackman window, n_fft 512, hop
128, 10 taps, delay 3, 3 iterations, eps 1e-6): per-frequency multichannel
linear prediction with delayed taps, inverse-power weighting and ridge-
regularised normal equations, each bin normalised to unit RMS first (WPE is
scale-equivariant, and near-empty bins otherwise give badly scaled solves).
All F bins (and all items of a batch) are one batched
``torch.linalg.solve``; the JAX package's real 2K × 2K block embedding of
each solve is a TPU workaround that torch does not need. The STFT is
centred with reflect padding, and the iSTFT is a window-sum normalised
shift-and-sum of ``n_fft // hop`` lanes; both stay float32.

The per-bin work (normalisation, weighted correlations, solves) runs in
complex128, where the JAX function, for want of float64 on the TPU, runs
complex64. On a tonal 10 s signal the complex64 iterations are unstable: a
1e-6 relative change of the input moves the output by 18–57 %, so two
backends (the CPU and the card) give unrelated outputs. In complex128 the
same change moves it by < 1 %. At 1 s the port is as close to the JAX
function (≈ 0.03 relative) as the JAX function's own rounding allows, and,
like it, correlates > 0.95 with the float64 host WPE without being
waveform-identical to it (its ridge is 1e-6, the host's 1e-10;
``tests/test_torch_wpe.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.from_numpy(np.blackman(n_fft).astype(np.float32)).to(device)


def stft(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., N) float32 → (..., F, T) complex64, centred with reflect padding."""
    pad = n_fft // 2
    lead = audio.shape[:-1]
    x = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad), mode="reflect")
    frames = x.reshape(*lead, -1).unfold(-1, n_fft, hop) * _window(n_fft, audio.device)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, length: int, n_fft: int, hop: int) -> torch.Tensor:
    """(..., F, T) → (..., length): overlap-add of the windowed frames,
    divided by the summed squared window."""
    if n_fft % hop:
        raise ValueError(f"the shift-and-sum overlap-add needs hop | n_fft; got {hop}, {n_fft}.")
    lanes = n_fft // hop
    window = _window(n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    T = frames.shape[-2]
    # Frame t covers out[t*hop : t*hop + n_fft]: split it into `lanes`
    # hop-sized pieces and add piece k at block t + k.
    pieces = frames.reshape(*frames.shape[:-2], T, lanes, hop)
    out = frames.new_zeros((*frames.shape[:-2], T + lanes - 1, hop))
    wsum = frames.new_zeros((T + lanes - 1, hop))
    w_pieces = (window ** 2).reshape(lanes, hop)
    for k in range(lanes):
        out[..., k:k + T, :] += pieces[..., k, :]
        wsum[k:k + T] += w_pieces[k]
    out_len = n_fft + hop * (T - 1)
    out = out.reshape(*out.shape[:-2], -1)[..., :out_len]
    wsum = wsum.reshape(-1)[:out_len]
    out = out / torch.where(wsum > 1e-10, wsum, torch.ones_like(wsum))
    pad = n_fft // 2
    return out[..., pad:pad + length]


def _wpe_bins(Y: torch.Tensor, taps: int, delay: int, iterations: int, eps: float) -> torch.Tensor:
    """(..., C, T) complex → (..., C, T): WPE of every bin in the leading
    dims at once."""
    T = Y.shape[-1]
    rms = torch.sqrt(torch.clamp_min(Y.abs().square().mean(dim=(-2, -1), keepdim=True), 1e-20))
    Y = Y / rms
    # Delayed taps: row (tau, c) is channel c shifted right by delay + tau.
    Ytilde = torch.cat([F.pad(Y, (delay + tau, 0))[..., :T] for tau in range(taps)], dim=-2)
    K = Ytilde.shape[-2]
    eye = torch.eye(K, dtype=Y.dtype, device=Y.device)
    X = Y
    for _ in range(iterations):
        power = torch.clamp_min(X.abs().square().mean(dim=-2), eps)
        Yw = Ytilde / power[..., None, :]
        R = Yw @ Ytilde.conj().transpose(-1, -2)
        P = Yw @ Y.conj().transpose(-1, -2)
        trace = torch.diagonal(R, dim1=-2, dim2=-1).real.sum(-1)
        reg = eps * trace / K + eps
        R = R + eye * reg[..., None, None]
        G = torch.linalg.solve(R, P)
        X = Y - G.conj().transpose(-1, -2) @ Ytilde
    return X * rms


def dereverb_wpe(
    audio,
    n_fft: int = 512,
    hop_length: int = 128,
    taps: int = 10,
    delay: int = 3,
    iterations: int = 3,
    eps: float = 1e-6,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """
    WPE dereverberation of ``(channels, samples)`` or ``(batch, channels,
    samples)`` audio; returns float32 of the same shape on the device it ran
    on.

    :param audio: numpy array or tensor. A tensor runs where it lives.
    :param device: where a numpy input runs: the card unless the caller asks
        for the CPU (``device="cpu"``).
    :param eps: the power floor and ridge, 1e-6 as in the JAX function (the
        host float64 WPE uses 1e-10, below complex64 rounding).
    """
    if isinstance(audio, torch.Tensor):
        x = audio.to(torch.float32)
    else:
        x = torch.from_numpy(np.asarray(audio, np.float32)).to(device or "cuda")
    if x.ndim not in (2, 3):
        raise ValueError(f"WPE takes (C, N) or (B, C, N) audio; got shape {tuple(x.shape)}.")
    N = x.shape[-1]
    # (..., F, C, T), contiguous: each item then has the memory layout it has
    # alone, and its reductions sum in the same order batched or not.
    Y = stft(x, n_fft, hop_length).transpose(-3, -2).to(torch.complex128).contiguous()
    Z = _wpe_bins(Y, taps, delay, iterations, eps).to(torch.complex64).transpose(-3, -2)
    return istft(Z, N, n_fft, hop_length)
