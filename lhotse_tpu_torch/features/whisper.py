"""
Whisper's log-Mel filterbank (port of ``lhotse_tpu/features/whisper.py``,
itself OpenAI Whisper's ``log_mel_spectrogram``).

- :func:`slaney_mel_filters` is a copy of the JAX package's float64 numpy
  Slaney-scale, Slaney-normalised mel bank (librosa's defaults), equal to
  it bit for bit.
- The centred STFT (reflect padding, periodic Hann, hop 160, n_fft 400, the
  last frame dropped) is a real-DFT product over the frames, then the power
  spectrum and the mel product, all torch GEMMs on ``config.device`` in
  IEEE fp32 (:func:`_stft_mel`, shared with
  :mod:`lhotse_tpu_torch.features.librosa_fbank`). They are plain matrix
  products, as in the JAX package: no kernel of the port runs here.

``config.device`` is the torch device: ``"cuda"`` unless the caller asks
for another; a config dict the JAX package wrote carries ``device: cpu``.
Whisper's normalisation depends on the whole utterance
(``max(log_spec, max - 8)``), so feature-domain mixing is not defined.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, Optional

import numpy as np
import torch

from lhotse_tpu_torch.features.base import FeatureExtractor, register_extractor
from lhotse_tpu_torch.ops.fbank import raw_dft_matrices
from lhotse_tpu_torch.utils import Seconds, asdict_nonull, compute_num_frames_from_samples


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney auditory-toolbox mel scale (librosa's default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = f / f_sp
    above = f >= min_log_hz
    mels = np.where(
        above, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = m * f_sp
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=None)
def slaney_mel_filters(
    sampling_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None,
) -> np.ndarray:
    """
    Triangular mel filterbank matching ``librosa.filters.mel`` defaults
    (htk=False, norm="slaney"); shape (n_mels, n_fft//2+1).
    """
    if fmax is None:
        fmax = sampling_rate / 2.0
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(float(fmin)), _hz_to_mel_slaney(float(fmax)), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney-style energy normalization: each filter integrates to ~2/bandwidth.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _stft_mel(audio: np.ndarray, n_fft: int, hop: int, num_frames: int, window: np.ndarray,
              filters: np.ndarray, device, magnitude: bool = False) -> torch.Tensor:
    """
    The mel projection of the centred STFT of a 1-D float32 signal, a
    (num_frames, n_mels) float32 tensor on ``device``: the signal
    reflect-padded by ``n_fft // 2`` on both sides, ``num_frames`` frames at
    a ``hop`` stride, windowed, through the real-DFT products, to power (or
    ``magnitude``), through the mel product. Every product is an fp32 GEMM.
    """
    device = torch.device(device)
    padded = np.pad(audio, (n_fft // 2, n_fft // 2), mode="reflect")
    x = torch.from_numpy(padded).to(device)
    frames = x.unfold(0, n_fft, hop)[:num_frames] * torch.from_numpy(window).to(device)
    C, S = (torch.from_numpy(m).to(device) for m in raw_dft_matrices(n_fft, n_fft))
    re, im = frames @ C, frames @ S
    spec = re * re + im * im
    if magnitude:
        spec = torch.sqrt(spec)
    return spec @ torch.from_numpy(np.ascontiguousarray(filters.T)).to(device)


def _hann(n: int) -> np.ndarray:
    """The periodic Hann window, as ``torch.hann_window(n)``, in float32."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


@dataclass
class WhisperFbankConfig:
    num_filters: int = 80
    device: str = "cuda"

    def to_dict(self) -> Dict[str, Any]:
        return asdict_nonull(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "WhisperFbankConfig":
        return WhisperFbankConfig(**data)


@register_extractor
class WhisperFbank(FeatureExtractor):
    """
    Log-Mel features as Whisper computes them: centred power STFT, Slaney
    mel projection, ``log10`` clamped at 1e-10, floored at the utterance
    maximum minus 8, then mapped through ``(x + 4) / 4``.
    """

    name = "whisper-fbank"
    config_type = WhisperFbankConfig

    def __init__(self, config=None):
        super().__init__(config=config)
        self.sampling_rate = 16000
        self.hop_length = 160
        self.n_fft = 400
        self.num_filters = self.config.num_filters
        self.filters = slaney_mel_filters(self.sampling_rate, self.n_fft, self.num_filters)
        self.window = _hann(self.n_fft)

    @property
    def device(self) -> torch.device:
        return torch.device(self.config.device)

    @property
    def frame_shift(self) -> Seconds:
        return self.hop_length / self.sampling_rate

    def to(self, device) -> None:
        self.config.device = device

    def feature_dim(self, sampling_rate: int) -> int:
        return self.num_filters

    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        assert sampling_rate == self.sampling_rate, (
            f"WhisperFbank was instantiated for sampling_rate "
            f"{self.sampling_rate}, but sampling_rate={sampling_rate} was "
            f"passed to extract(). Note you can use CutSet/RecordingSet."
            f"resample() to change the audio sampling rate."
        )
        samples = np.asarray(samples)
        if samples.ndim == 2:
            if samples.shape[0] > 1:
                raise ValueError("Whisper Fbank works only with single-channel recordings.")
            samples = samples[0]
        x = samples.astype(np.float32, copy=False)
        num_samples = len(x)
        # torch.stft gives 1 + len // hop centred frames; Whisper drops the last.
        num_frames = max(num_samples // self.hop_length, 0)
        if num_frames > 0:
            mel_spec = _stft_mel(x, self.n_fft, self.hop_length, num_frames, self.window,
                                 self.filters, self.device)
            log_spec = torch.log10(torch.clamp(mel_spec, min=1e-10))
            log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
            log_spec = ((log_spec + 4.0) / 4.0).cpu().numpy()
        else:
            log_spec = np.zeros((0, self.num_filters), dtype=np.float32)
        # Whisper zero-pads to the rounded frame count for short inputs.
        target = compute_num_frames_from_samples(
            num_samples=num_samples, frame_shift=self.frame_shift, sampling_rate=self.sampling_rate)
        if target > log_spec.shape[0]:
            log_spec = np.pad(log_spec, ((0, target - log_spec.shape[0]), (0, 0)))
        return log_spec.astype(np.float32)

    @staticmethod
    def mix(
        features_a: np.ndarray, features_b: np.ndarray, energy_scaling_factor_b: float,
    ) -> np.ndarray:
        raise ValueError(
            "Mixing is not defined for Whisper filter-bank features: its "
            "per-utterance max normalization makes the transform non-linear."
        )

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        raise ValueError("Energy is not defined for Whisper filter-bank features.")


def log_mel_spectrogram(
    audio: np.ndarray,
    filters: Optional[np.ndarray] = None,
    n_mels: int = 80,
    n_fft: int = 400,
    window: Optional[np.ndarray] = None,
    hop_length: int = 160,
    sampling_rate: int = 16000,
    device="cuda",
) -> np.ndarray:
    """
    Functional Whisper log-Mel spectrogram, ``(n_mels, T)``, computed on
    ``device``. ``filters`` / ``window`` replace the Slaney mel bank and the
    periodic Hann window when given.
    """
    fb = WhisperFbank(WhisperFbankConfig(num_filters=n_mels, device=device))
    fb.n_fft = n_fft
    fb.hop_length = hop_length
    fb.sampling_rate = sampling_rate
    if filters is not None:
        fb.filters = np.asarray(filters, dtype=np.float32)
    else:
        fb.filters = slaney_mel_filters(sampling_rate, n_fft, n_mels)
    fb.window = _hann(n_fft) if window is None else np.asarray(window, dtype=np.float32)
    return fb.extract(np.asarray(audio), sampling_rate).T
