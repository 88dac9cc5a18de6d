"""
The extractors under the ``"kaldifeat-fbank"`` and ``"kaldifeat-mfcc"``
names (port of ``lhotse_tpu/features/kaldifeat.py``). The reference wraps
the external ``kaldifeat`` package; here, as in the JAX package, the
classes keep its registry names and nested config (``frame_opts`` /
``mel_opts``, with the ``samp_freq`` / ``frame_shift_ms`` /
``frame_length_ms`` keys of its serialised form) and delegate to the port's
``Fbank`` / ``Mfcc``, so the fused fbank kernel computes them on the card.
``extract`` takes one signal or a list of them, and gives one matrix or a
list.

``config.device`` is the torch device: ``"cuda"`` unless the caller asks
for another. A config dict the JAX package wrote carries its default
``device: cpu``, which runs the kernel's plain version on the CPU.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Sequence, Union

import numpy as np
import torch

from lhotse_tpu_torch.features.base import FeatureExtractor, register_extractor
from lhotse_tpu_torch.features.compliance import _log_mix
from lhotse_tpu_torch.features.kaldi.extractors import Fbank, FbankConfig, Mfcc, MfccConfig
from lhotse_tpu_torch.utils import EPSILON, Seconds


@dataclass
class KaldifeatFrameOptions:
    sampling_rate: int = 16000
    frame_shift: Seconds = 0.01
    frame_length: Seconds = 0.025
    dither: float = 0.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["samp_freq"] = float(d.pop("sampling_rate"))
        d["frame_shift_ms"] = d.pop("frame_shift") * 1000.0
        d["frame_length_ms"] = d.pop("frame_length") * 1000.0
        return d

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "KaldifeatFrameOptions":
        data = dict(data)
        if "samp_freq" in data:
            data["sampling_rate"] = int(data.pop("samp_freq"))
        for key in ("frame_shift_ms", "frame_length_ms"):
            if key in data:
                data[key.replace("_ms", "")] = data.pop(key) / 1000
        return KaldifeatFrameOptions(**data)


@dataclass
class KaldifeatMelOptions:
    num_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = -400.0
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    debug_mel: bool = False
    htk_mode: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "KaldifeatMelOptions":
        return KaldifeatMelOptions(**data)


def _nested_from_dict(cls, data: Dict[str, Any]):
    data = dict(data)
    if isinstance(data.get("frame_opts"), dict):
        data["frame_opts"] = KaldifeatFrameOptions.from_dict(data["frame_opts"])
    if isinstance(data.get("mel_opts"), dict):
        data["mel_opts"] = KaldifeatMelOptions.from_dict(data["mel_opts"])
    return cls(**data)


class _KaldifeatNamedExtractor(FeatureExtractor):
    """Delegation onto the port's Kaldi extractors, and the list-in /
    list-out ``extract`` of the reference's kaldifeat extractors."""

    def __init__(self, config=None):
        super().__init__(config=config)
        assert not self.config.mel_opts.htk_mode, "htk_mode is not supported."
        self._impl = self._make_delegate()

    def _make_delegate(self) -> FeatureExtractor:
        raise NotImplementedError

    def _frame_params(self) -> Dict[str, Any]:
        fo = self.config.frame_opts
        return dict(
            sampling_rate=fo.sampling_rate, frame_shift=fo.frame_shift,
            frame_length=fo.frame_length, dither=fo.dither, preemph_coeff=fo.preemph_coeff,
            remove_dc_offset=fo.remove_dc_offset, window_type=fo.window_type,
            round_to_power_of_two=fo.round_to_power_of_two, snip_edges=fo.snip_edges,
            use_energy=self.config.use_energy, device=self.config.device)

    @property
    def device(self) -> torch.device:
        return torch.device(self.config.device)

    def to(self, device) -> None:
        self.config.device = device
        self._impl.to(device)

    @property
    def frame_shift(self) -> Seconds:
        return self.config.frame_opts.frame_shift

    def extract(self, samples: Union[np.ndarray, Sequence[np.ndarray]], sampling_rate: int):
        expected_sr = self.config.frame_opts.sampling_rate
        assert sampling_rate == expected_sr, (
            f"Mismatched sampling rate: extractor expects {expected_sr}, got {sampling_rate}")
        if isinstance(samples, (list, tuple)):
            return [self._impl.extract(np.atleast_1d(np.squeeze(s)), sampling_rate)
                    for s in samples]
        return self._impl.extract(samples, sampling_rate)

    def extract_batch(self, samples, sampling_rate: int, lengths=None):
        if lengths is not None:
            samples = [np.asarray(x)[:l] for x, l in zip(samples, lengths)]
        return self.extract(samples, sampling_rate)


@dataclass
class KaldifeatFbankConfig:
    frame_opts: KaldifeatFrameOptions = field(default_factory=KaldifeatFrameOptions)
    mel_opts: KaldifeatMelOptions = field(default_factory=KaldifeatMelOptions)
    use_energy: bool = False
    use_log_fbank: bool = True
    use_power: bool = True
    device: str = "cuda"

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["frame_opts"] = self.frame_opts.to_dict()
        d["mel_opts"] = self.mel_opts.to_dict()
        return d

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "KaldifeatFbankConfig":
        return _nested_from_dict(KaldifeatFbankConfig, data)


@register_extractor
class KaldifeatFbank(_KaldifeatNamedExtractor):
    name = "kaldifeat-fbank"
    config_type = KaldifeatFbankConfig

    def _make_delegate(self) -> Fbank:
        assert self.config.use_log_fbank, "use_log_fbank=False is not supported."
        return Fbank(FbankConfig(
            **self._frame_params(), low_freq=self.config.mel_opts.low_freq,
            high_freq=self.config.mel_opts.high_freq, num_filters=self.config.mel_opts.num_bins,
            use_fft_mag=not self.config.use_power, torchaudio_compatible_mel_scale=True))

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.mel_opts.num_bins

    @staticmethod
    def mix(features_a, features_b, energy_scaling_factor_b):
        return _log_mix(features_a, features_b, energy_scaling_factor_b)

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        return float(np.sum(np.exp(features)))


@dataclass
class KaldifeatMfccConfig:
    frame_opts: KaldifeatFrameOptions = field(default_factory=KaldifeatFrameOptions)
    mel_opts: KaldifeatMelOptions = field(default_factory=lambda: KaldifeatMelOptions(num_bins=23))
    num_ceps: int = 13
    use_energy: bool = False
    energy_floor: float = EPSILON
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    htk_compat: bool = False
    device: str = "cuda"

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["frame_opts"] = self.frame_opts.to_dict()
        d["mel_opts"] = self.mel_opts.to_dict()
        return d

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "KaldifeatMfccConfig":
        return _nested_from_dict(KaldifeatMfccConfig, data)


@register_extractor
class KaldifeatMfcc(_KaldifeatNamedExtractor):
    name = "kaldifeat-mfcc"
    config_type = KaldifeatMfccConfig

    def _make_delegate(self) -> Mfcc:
        assert not self.config.htk_compat, "htk_compat is not supported."
        return Mfcc(MfccConfig(
            **self._frame_params(), energy_floor=self.config.energy_floor,
            raw_energy=self.config.raw_energy, low_freq=self.config.mel_opts.low_freq,
            high_freq=self.config.mel_opts.high_freq, num_filters=self.config.mel_opts.num_bins,
            num_ceps=self.config.num_ceps, cepstral_lifter=int(self.config.cepstral_lifter),
            torchaudio_compatible_mel_scale=True))

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_ceps


# The reference's shared base class of its kaldifeat wrappers, under its public name.
KaldifeatExtractor = _KaldifeatNamedExtractor
