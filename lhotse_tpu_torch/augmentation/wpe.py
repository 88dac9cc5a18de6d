"""
Dereverberation with Weighted Prediction Error (WPE) on the host (copied
from ``lhotse_tpu/augmentation/wpe.py``): self-contained numpy, the
iterative WPE algorithm (per-frequency multichannel linear prediction with
delayed taps, inverse-power weighting and regularized normal-equation
solves) behind a blackman-window STFT (n_fft=512, hop=128, taps=10,
delay=3, 3 iterations). ``DereverbWPE`` is the lazily applied
``Recording`` transform. It sees every channel at once, so a recording
whose chain holds it reads all of its channels before a channel subset is
picked (``channel_wise``).

The device WPE of :mod:`lhotse_tpu_torch.ops.wpe` is a separate
implementation.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional, Tuple

import numpy as np

from lhotse_tpu_torch.augmentation.transform import AudioTransform
from lhotse_tpu_torch.utils import Seconds


def _stft(audio: np.ndarray, n_fft: int, hop: int, window: np.ndarray) -> np.ndarray:
    """Centered STFT returning (channels, freqs, frames)."""
    C, N = audio.shape
    pad = n_fft // 2
    x = np.pad(audio, ((0, 0), (pad, pad)), mode="reflect")
    num_frames = 1 + (x.shape[1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(num_frames)[:, None]
    frames = x[:, idx] * window[None, None, :]
    return np.fft.rfft(frames, axis=-1).transpose(0, 2, 1)


def _istft(spec: np.ndarray, n_fft: int, hop: int, window: np.ndarray, length: int) -> np.ndarray:
    """Inverse of :func:`_stft` with window-sum normalization."""
    C, F, T = spec.shape
    frames = np.fft.irfft(spec.transpose(0, 2, 1), n=n_fft, axis=-1)
    frames *= window[None, None, :]
    out_len = n_fft + hop * (T - 1)
    out = np.zeros((C, out_len))
    win_sum = np.zeros(out_len)
    for t in range(T):
        out[:, t * hop : t * hop + n_fft] += frames[:, t]
        win_sum[t * hop : t * hop + n_fft] += window**2
    win_sum = np.where(win_sum > 1e-10, win_sum, 1.0)
    out = out / win_sum[None, :]
    pad = n_fft // 2
    return out[:, pad : pad + length]


def wpe(
    Y: np.ndarray, taps: int = 10, delay: int = 3, iterations: int = 3, eps: float = 1e-10,
) -> np.ndarray:
    """
    WPE dereverberation for a single frequency band.

    :param Y: observed STFT of shape (channels, frames), complex.
    :return: dereverberated STFT, same shape.
    """
    C, T = Y.shape
    X = Y.copy()
    # Build the delayed-tap matrix: Ytilde[(c,tau), t] = Y[c, t - delay - tau]
    Ytilde = np.zeros((C * taps, T), dtype=Y.dtype)
    for tau in range(taps):
        shift = delay + tau
        if shift < T:
            Ytilde[tau * C : (tau + 1) * C, shift:] = Y[:, : T - shift]
    for _ in range(iterations):
        power = np.mean(np.abs(X) ** 2, axis=0)
        power = np.maximum(power, eps)
        Yw = Ytilde / power[None, :]
        R = Yw @ Ytilde.conj().T  # (C*taps, C*taps)
        P = Yw @ Y.conj().T  # (C*taps, C)
        R += np.eye(R.shape[0]) * (eps * np.trace(R).real / max(R.shape[0], 1) + eps)
        try:
            G = np.linalg.solve(R, P)  # (C*taps, C)
        except np.linalg.LinAlgError:
            G = np.linalg.lstsq(R, P, rcond=None)[0]
        X = Y - G.conj().T @ Ytilde
    return X


def dereverb_wpe_numpy(
    audio: np.ndarray, n_fft: int = 512, hop_length: int = 128, taps: int = 10, delay: int = 3,
    iterations: int = 3, statistics_mode: str = "full") -> np.ndarray:
    """Apply WPE dereverberation to (channels, samples) audio."""
    assert audio.ndim == 2, f"Expected 2D audio shape, got: {audio.shape}"
    N = audio.shape[1]
    window = np.blackman(n_fft)
    Y = _stft(audio, n_fft, hop_length, window)  # (C, F, T)
    Z = np.empty_like(Y)
    for f in range(Y.shape[1]):
        Z[:, f, :] = wpe(Y[:, f, :], taps=taps, delay=delay, iterations=iterations)
    out = _istft(Z, n_fft, hop_length, window, N)
    return out.astype(audio.dtype, copy=False)


def dereverb_wpe_torch(
    audio, n_fft: int = 512, hop_length: int = 128, taps: int = 10, delay: int = 3,
    iterations: int = 3, statistics_mode: str = "full"):
    """Torch-tensor front-end over the host numpy WPE of
    :func:`dereverb_wpe_numpy`, as in the JAX package: ``audio`` (channels,
    samples) may lie on any device; it is copied to the host, dereverberated
    there in numpy, and the result is copied back to that device with
    ``audio``'s dtype. The WPE that runs on the card is
    :func:`lhotse_tpu_torch.ops.wpe.dereverb_wpe`."""
    import torch

    out = dereverb_wpe_numpy(
        audio.detach().cpu().numpy(), n_fft=n_fft, hop_length=hop_length, taps=taps, delay=delay,
        iterations=iterations, statistics_mode=statistics_mode)
    return torch.from_numpy(out).to(device=audio.device, dtype=audio.dtype)


@dataclass
class DereverbWPE(AudioTransform):
    """Dereverberation with Weighted Prediction Error (WPE)."""

    n_fft: int = 512
    hop_length: int = 128
    taps: int = 10
    delay: int = 3
    iterations: int = 3
    statistics_mode: str = "full"

    channel_wise = False

    def __call__(self, samples: np.ndarray, *args, **kwargs) -> np.ndarray:
        return dereverb_wpe_numpy(np.asarray(samples), **asdict(self))

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: int,
    ) -> Tuple[Seconds, Optional[Seconds]]:
        return offset, duration
