"""
TTS-style log-mel fbank with librosa's semantics (port of
``lhotse_tpu/features/librosa_fbank.py``; ``logmelfilterbank`` as
ParallelWaveGAN-family projects use it): the centred magnitude STFT
(reflect padding, periodic Hann), the Slaney-scale, Slaney-normalised mel
projection over fmin..fmax, ``log10`` with an epsilon floor, padded or
truncated to the frame count of the duration.

The mel bank is :func:`lhotse_tpu_torch.features.whisper.slaney_mel_filters`
and the STFT and mel products are fp32 torch GEMMs on the extractor's
device (:func:`lhotse_tpu_torch.features.whisper._stft_mel`). The config has
no ``device`` field, so the extractor takes its device from :meth:`to`: the
card unless the caller asks for another.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from lhotse_tpu_torch.features.base import FeatureExtractor, register_extractor
from lhotse_tpu_torch.features.compliance import _log_mix
from lhotse_tpu_torch.features.whisper import _hann, _stft_mel, slaney_mel_filters
from lhotse_tpu_torch.utils import EPSILON, LOG_EPSILON, Seconds, compute_num_frames


@dataclass
class LibrosaFbankConfig:
    """Defaults consistent with popular TTS projects (e.g. ParallelWaveGAN)."""

    sampling_rate: int = 22050
    fft_size: int = 1024
    hop_size: int = 256
    win_length: Optional[int] = None
    window: str = "hann"
    num_mel_bins: int = 80
    fmin: int = 80
    fmax: int = 7600

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "LibrosaFbankConfig":
        return LibrosaFbankConfig(**data)


def pad_or_truncate_features(
    feats: np.ndarray, expected_num_frames: int, abs_tol: int = 1, pad_value: float = LOG_EPSILON,
) -> np.ndarray:
    """Tolerate a ±1 frame drift between the STFT's hop count and the frame
    count of the duration."""
    frames_diff = feats.shape[0] - expected_num_frames
    if 0 < frames_diff <= abs_tol:
        feats = feats[:expected_num_frames]
    elif -abs_tol <= frames_diff < 0:
        feats = np.pad(
            feats, ((0, -frames_diff), (0, 0)), mode="constant", constant_values=pad_value)
    elif abs(frames_diff) > abs_tol:
        raise ValueError(
            f"Expected {expected_num_frames} feature frames; "
            f"feats.shape[0] = {feats.shape[0]}"
        )
    return feats


def logmelfilterbank(
    audio: np.ndarray, sampling_rate: int, fft_size: int = 1024, hop_size: int = 256,
    win_length: Optional[int] = None, window: str = "hann", num_mel_bins: int = 80, fmin: int = 80,
    fmax: int = 7600, eps: float = EPSILON, device="cuda") -> np.ndarray:
    """Log-mel feature matrix (num_frames, num_mel_bins), computed on ``device``."""
    assert window == "hann", "Only the hann window is supported."
    audio = np.asarray(audio)
    if audio.ndim == 2:
        assert audio.shape[0] == 1, (
            f"LibrosaFbank works only with single-channel recordings (shape: {audio.shape})")
        audio = audio[0]
    assert audio.ndim == 1

    if win_length is None:
        win_length = fft_size
    # librosa centres the window inside the FFT buffer when win_length < n_fft.
    pad_left = (fft_size - win_length) // 2
    window_full = np.zeros(fft_size, dtype=np.float32)
    window_full[pad_left : pad_left + win_length] = _hann(win_length)

    fmin = 0 if fmin is None else fmin
    fmax = sampling_rate / 2 if fmax is None else fmax
    mel_basis = slaney_mel_filters(
        sampling_rate, fft_size, num_mel_bins, fmin=float(fmin), fmax=float(fmax))
    num_frames = 1 + len(audio) // hop_size
    mel = _stft_mel(audio.astype(np.float32, copy=False), fft_size, hop_size, num_frames,
                    window_full, mel_basis, device, magnitude=True)
    feats = torch.log10(torch.clamp(mel, min=eps)).cpu().numpy()

    expected_num_frames = compute_num_frames(
        duration=len(audio) / sampling_rate, frame_shift=hop_size / sampling_rate,
        sampling_rate=sampling_rate)
    return pad_or_truncate_features(feats, expected_num_frames).astype(np.float32)


@register_extractor
class LibrosaFbank(FeatureExtractor):
    name = "librosa-fbank"
    config_type = LibrosaFbankConfig

    def __init__(self, config=None):
        super().__init__(config=config)
        self._device = "cuda"

    @property
    def device(self) -> torch.device:
        return torch.device(self._device)

    def to(self, device) -> None:
        self._device = device

    @property
    def frame_shift(self) -> Seconds:
        return self.config.hop_size / self.config.sampling_rate

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_mel_bins

    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        assert sampling_rate == self.config.sampling_rate
        return logmelfilterbank(samples, **asdict(self.config), device=self._device)

    @staticmethod
    def mix(features_a, features_b, energy_scaling_factor_b):
        return _log_mix(features_a, features_b, energy_scaling_factor_b)

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        return float(np.sum(np.exp(features)))

    @staticmethod
    def scale(features: np.ndarray, energy_scaling_factor: float) -> np.ndarray:
        return features + np.log(energy_scaling_factor)
