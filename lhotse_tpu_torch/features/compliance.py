"""
The extractors under the plain names ``"fbank"``, ``"mfcc"`` and
``"spectrogram"`` (port of ``lhotse_tpu/features/compliance.py``): the
feature types that manifests written by upstream lhotse carry, whose
torchaudio-compliance configs name the same Kaldi computation as the
port's extractors.

Each maps its compliance-style config onto the port's Kaldi extractor with
``snip_edges=False``, as the reference's wrapper does, so ``fbank`` and
``mfcc`` run the fused fbank kernel for a CUDA device (its plain version on
the CPU) and ``spectrogram`` the plain GEMM route. The configs have no
``device`` field, so the extractor takes its device from :meth:`to`: the
card unless the caller asks for another.

Deliberate deviations, both asserted at construction, as in the JAX
package: VTLN warping (``vtln_warp != 1.0``) is not implemented, and only
``min_duration == 0.0`` is supported.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict

import numpy as np
import torch

from lhotse_tpu_torch.features.base import FeatureExtractor, register_extractor
from lhotse_tpu_torch.features.kaldi.extractors import (
    Fbank, FbankConfig, LogSpectrogram, LogSpectrogramConfig, Mfcc, MfccConfig)
from lhotse_tpu_torch.utils import EPSILON, Seconds


@dataclass
class TorchaudioFbankConfig:
    dither: float = 0.0
    window_type: str = "povey"
    frame_length: Seconds = 0.025
    frame_shift: Seconds = 0.01
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    energy_floor: float = EPSILON
    min_duration: float = 0.0
    preemphasis_coefficient: float = 0.97
    raw_energy: bool = True
    low_freq: float = 20.0
    high_freq: float = -400.0
    num_mel_bins: int = 80
    use_energy: bool = False
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    vtln_warp: float = 1.0

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "TorchaudioFbankConfig":
        return TorchaudioFbankConfig(**data)


@dataclass
class TorchaudioMfccConfig:
    dither: float = 0.0
    window_type: str = "povey"
    frame_length: Seconds = 0.025
    frame_shift: Seconds = 0.01
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    energy_floor: float = EPSILON
    min_duration: float = 0.0
    preemphasis_coefficient: float = 0.97
    raw_energy: bool = True
    low_freq: float = 20.0
    high_freq: float = -400.0
    num_mel_bins: int = 23
    use_energy: bool = False
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    vtln_warp: float = 1.0
    cepstral_lifter: float = 22.0
    num_ceps: int = 13

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "TorchaudioMfccConfig":
        return TorchaudioMfccConfig(**data)


@dataclass
class TorchaudioSpectrogramConfig:
    dither: float = 0.0
    window_type: str = "povey"
    frame_length: Seconds = 0.025
    frame_shift: Seconds = 0.01
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    energy_floor: float = EPSILON
    min_duration: float = 0.0
    preemphasis_coefficient: float = 0.97
    raw_energy: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "TorchaudioSpectrogramConfig":
        return TorchaudioSpectrogramConfig(**data)


def _log_mix(features_a, features_b, energy_scaling_factor_b):
    return np.log(
        np.maximum(EPSILON, np.exp(features_a) + energy_scaling_factor_b * np.exp(features_b)))


class _ComplianceExtractor(FeatureExtractor):
    """Delegation onto the port's Kaldi extractors, one delegate per
    sampling rate (the compliance API passes the rate at extract time), each
    on this extractor's device."""

    def __init__(self, config=None):
        super().__init__(config=config)
        assert getattr(self.config, "vtln_warp", 1.0) == 1.0, (
            "VTLN warping is not supported by this extractor (vtln_warp must be 1.0).")
        assert getattr(self.config, "min_duration", 0.0) == 0.0, (
            "min_duration is not supported by this extractor (must be 0.0).")
        self._device = "cuda"
        self._delegates: Dict[int, FeatureExtractor] = {}

    @property
    def device(self) -> torch.device:
        return torch.device(self._device)

    def to(self, device) -> None:
        self._device = device
        for delegate in self._delegates.values():
            delegate.to(device)

    def _base_params(self, sampling_rate: int) -> Dict[str, Any]:
        c = self.config
        return dict(
            sampling_rate=sampling_rate, frame_length=c.frame_length, frame_shift=c.frame_shift,
            round_to_power_of_two=c.round_to_power_of_two, remove_dc_offset=c.remove_dc_offset,
            preemph_coeff=c.preemphasis_coefficient, window_type=c.window_type, dither=c.dither,
            snip_edges=False, energy_floor=c.energy_floor, raw_energy=c.raw_energy,
            device=self._device)

    def _make_delegate(self, sampling_rate: int) -> FeatureExtractor:
        raise NotImplementedError

    def _delegate(self, sampling_rate: int) -> FeatureExtractor:
        if sampling_rate not in self._delegates:
            self._delegates[sampling_rate] = self._make_delegate(sampling_rate)
        return self._delegates[sampling_rate]

    @property
    def frame_shift(self) -> Seconds:
        return self.config.frame_shift

    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        samples = np.asarray(samples)
        if samples.ndim == 2:
            assert samples.shape[0] == 1, "This extractor expects single-channel input."
            samples = samples[0]
        return self._delegate(sampling_rate).extract(samples, sampling_rate)

    def extract_batch(self, samples, sampling_rate: int, lengths=None):
        return self._delegate(sampling_rate).extract_batch(samples, sampling_rate, lengths=lengths)


@register_extractor
class TorchaudioFbank(_ComplianceExtractor):
    """Log-mel fbank under the reference's ``"fbank"`` name: the fused fbank
    kernel on the card."""

    name = "fbank"
    config_type = TorchaudioFbankConfig

    def _make_delegate(self, sampling_rate: int) -> Fbank:
        c = self.config
        return Fbank(FbankConfig(
            **self._base_params(sampling_rate), low_freq=c.low_freq, high_freq=c.high_freq,
            num_filters=c.num_mel_bins, use_energy=c.use_energy,
            torchaudio_compatible_mel_scale=True))

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_mel_bins

    @staticmethod
    def mix(features_a, features_b, energy_scaling_factor_b):
        return _log_mix(features_a, features_b, energy_scaling_factor_b)

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        return float(np.sum(np.exp(features)))

    @staticmethod
    def scale(features: np.ndarray, energy_scaling_factor: float) -> np.ndarray:
        return features + np.log(energy_scaling_factor)


@register_extractor
class TorchaudioMfcc(_ComplianceExtractor):
    """MFCC under the reference's ``"mfcc"`` name: the fused fbank kernel's
    log-mel and a DCT on the card."""

    name = "mfcc"
    config_type = TorchaudioMfccConfig

    def _make_delegate(self, sampling_rate: int) -> Mfcc:
        c = self.config
        return Mfcc(MfccConfig(
            **self._base_params(sampling_rate), low_freq=c.low_freq, high_freq=c.high_freq,
            num_filters=c.num_mel_bins, use_energy=c.use_energy, num_ceps=c.num_ceps,
            cepstral_lifter=int(c.cepstral_lifter), torchaudio_compatible_mel_scale=True))

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_ceps


@register_extractor
class TorchaudioSpectrogram(_ComplianceExtractor):
    """Log power spectrogram, the raw frame log-energy in bin 0, under the
    reference's ``"spectrogram"`` name: the plain GEMM route."""

    name = "spectrogram"
    config_type = TorchaudioSpectrogramConfig

    def _make_delegate(self, sampling_rate: int) -> LogSpectrogram:
        # torchaudio.compliance.kaldi.spectrogram always stores the raw frame
        # log-energy in the zeroth coefficient.
        return LogSpectrogram(
            LogSpectrogramConfig(**self._base_params(sampling_rate), use_energy=True))

    def feature_dim(self, sampling_rate: int) -> int:
        window_size = int(self.config.frame_length * sampling_rate)
        if self.config.round_to_power_of_two:
            n_fft = 1
            while n_fft < window_size:
                n_fft *= 2
        else:
            n_fft = window_size
        return n_fft // 2 + 1

    @staticmethod
    def mix(features_a, features_b, energy_scaling_factor_b):
        return _log_mix(features_a, features_b, energy_scaling_factor_b)

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        return float(np.sum(np.exp(features)))

    @staticmethod
    def scale(features: np.ndarray, energy_scaling_factor: float) -> np.ndarray:
        return features + np.log(energy_scaling_factor)
