"""
Kaldi-compatible feature extractors — Fbank, Mfcc, Spectrogram,
LogSpectrogram — and their configs (port of the device route of
``lhotse_tpu/features/kaldi/extractors.py``).

``config.device`` is the torch device the extraction runs on. Each item is
given the snip_edges=False symmetric edge padding on the host, the batch is
zero-padded to its longest prepared item and copied to the device, and the
device frames it with snip-edges semantics: frames that cover real audio are
the same as the unpadded computation's, and each item's output is sliced to
its own frame count (:meth:`_num_frames`, for either ``snip_edges``).

- ``Fbank`` and ``Mfcc`` in the configurations the fused fbank kernel covers
  (400-sample frames, 160-sample hop, 512-point FFT, no energy column, power
  spectrum, zero Nyquist mel row — the JAX package's ``_pallas_matrices``
  conditions) take :func:`lhotse_tpu_torch.ops.fbank_cuda.fbank_fused_padded`:
  the CUDA kernel for a CUDA device, its plain version on the CPU. There is
  no fallback: a kernel that fails raises.
- Every other configuration, and ``Spectrogram``/``LogSpectrogram``, takes
  the GEMM route in plain torch (folded-preprocessing DFT matrices, power,
  then the extractor's postprocessing), as the JAX package takes its XLA
  route.

The JAX package's numpy/native host route, its shape buckets (which bound
XLA compiles), extractor registration and feature storage are not ported.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import asdict, dataclass, is_dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank, Wav2LogSpec, Wav2MFCC, Wav2Spec
from lhotse_tpu_torch.ops import fbank as ops
from lhotse_tpu_torch.ops import fbank_cuda
from lhotse_tpu_torch.ops.fbank import EPSILON

Seconds = float


def asdict_nonull(dclass) -> Dict[str, Any]:
    """
    Recursively convert a dataclass into a dict, removing all fields whose
    value is None (a copy of the JAX package's ``utils.asdict_nonull``). Keeps
    key order = dataclass field order.
    """

    def non_null_dict_factory(collection):
        d = dict(collection)
        for key in [k for k, v in d.items() if v is None]:
            del d[key]
        return d

    return asdict(dclass, dict_factory=non_null_dict_factory)


def compute_num_frames_from_samples(
    num_samples: int, frame_shift: Seconds, sampling_rate: int) -> int:
    """A copy of the JAX package's ``utils.compute_num_frames_from_samples``:
    the snip_edges=False frame count."""
    window_hop = round(frame_shift * sampling_rate)
    num_frames = int((num_samples + window_hop // 2) // window_hop)
    return num_frames


class _KaldiExtractorBase:
    """
    Shared batched device route. Subclasses give ``_postprocess`` (mel /
    log / DCT of the GEMM route's power spectrum), the layer ``extractor``
    whose constants they use, and, for the kernel route, ``_kernel_postprocess``.
    """

    name = None
    config_type = None

    def __init__(self, config=None):
        if config is None:
            config = self.config_type()
        if not is_dataclass(config):
            raise TypeError("The feature configuration object must be a dataclass.")
        self.config = config
        config_dict = self.config.to_dict()
        config_dict.pop("device", None)
        # The extractor dithers on the host (see _apply_dither), so its layer
        # holds the constants only and never dithers.
        config_dict["dither"] = 0.0
        self.extractor = self._layer_type(**config_dict)
        self._gemm_mats: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    # ---- config plumbing ----

    @property
    def device(self) -> torch.device:
        return torch.device(self.config.device)

    def to(self, device) -> None:
        self.config.device = device

    @property
    def frame_shift(self) -> Seconds:
        return self.config.frame_shift

    @property
    def _frame_samples(self) -> int:
        return int(math.floor(self.config.frame_length * self.config.sampling_rate))

    @property
    def _shift_samples(self) -> int:
        return int(math.floor(self.config.frame_shift * self.config.sampling_rate))

    @property
    def _fft_length(self) -> int:
        n = self._frame_samples
        return ops.next_power_of_2(n) if self.config.round_to_power_of_two else n

    def _layer(self):
        """``self.extractor`` with its buffers on ``self.device``."""
        if self.extractor.device != self.device:
            self.extractor.to(self.device)
        return self.extractor

    # ---- core batched compute ----

    def _analysis_matrices(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The folded preprocessing+DFT matrices ``Mc``/``Ms`` on ``device``."""
        mats = self._gemm_mats.get(device)
        if mats is None:
            cfg = self.config
            mats = tuple(
                torch.as_tensor(m, device=device) for m in ops.dft_analysis_matrices(
                    self._frame_samples, self._fft_length, window_type=cfg.window_type,
                    remove_dc_offset=cfg.remove_dc_offset, preemph_coeff=cfg.preemph_coeff))
            self._gemm_mats[device] = mats
        return mats

    def _kernel_postprocess(self, logmel: torch.Tensor) -> torch.Tensor:
        """Subclass hook: the fused kernel's log-mel into this extractor's
        features (identity for fbank)."""
        return logmel

    def _forward_padded_batch(self, samples: np.ndarray) -> torch.Tensor:
        """
        One forward over a padded (B, N) float32 batch on ``self.device``;
        returns a (B, T, F) tensor there. The items already carry the
        snip_edges=False edge padding (:meth:`_prepare_item`), so framing
        here is always snip-edges style.
        """
        layer = self._layer()
        x = torch.from_numpy(samples).to(self.device)
        fused = layer._fused_matrices() if hasattr(layer, "_fused_matrices") else None
        if fused is not None:
            Mc, Ms, fb, _ = fused
            return self._kernel_postprocess(fbank_cuda.fbank_fused_padded(
                x, Mc, Ms, fb, snip_edges=True, dft=layer._fused_dft))
        frames = ops.frame_signal(x, self._frame_samples, self._shift_samples, snip_edges=True)
        log_e = None
        if self.config.use_energy:
            centered = frames - torch.mean(frames, dim=-1, keepdim=True)
            log_e = ops.frame_log_energy(centered, self.config.energy_floor)
        Mc, Ms = self._analysis_matrices(x.device)
        pow_spec = ops.power_spectrum_gemm(frames, Mc, Ms, use_fft_mag=self.config.use_fft_mag)
        return self._postprocess(pow_spec, log_e)

    def _postprocess(self, pow_spec: torch.Tensor, log_e: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def _apply_dither(self, samples: np.ndarray) -> np.ndarray:
        """
        Host-side dither: additive Gaussian noise scaled by ``config.dither``
        before framing, drawn from the ambient numpy RNG as in the JAX
        package. No-op for the default ``dither == 0``.
        """
        d = float(getattr(self.config, "dither", 0.0) or 0.0)
        if d == 0.0:
            return samples
        noise = np.random.standard_normal(samples.shape).astype(np.float32)
        return samples + d * noise

    def _num_frames(self, num_samples: int) -> int:
        if self.config.snip_edges:
            return ops.compute_num_frames_snip(
                num_samples, self._frame_samples, self._shift_samples)
        return ops.compute_num_frames_pad(num_samples, self._shift_samples)

    def _prepare_item(self, x: np.ndarray) -> np.ndarray:
        """
        Host-side per-item preparation: apply the snip_edges=False symmetric
        edge padding so the padded batch can be framed with snip-edges
        semantics on the device. With snip_edges=True the item is returned
        as-is.
        """
        if self.config.snip_edges:
            return x
        length, shift = self._frame_samples, self._shift_samples
        n = x.shape[-1]
        num_frames = ops.compute_num_frames_pad(n, shift)
        new_num_samples = (num_frames - 1) * shift + length
        npad = new_num_samples - n
        npad_left = (length - shift) // 2
        npad_right = npad - npad_left
        pad_left = x[:npad_left][::-1]
        if npad_right >= 0:
            pad_right = x[n - npad_right :][::-1] if npad_right > 0 else x[:0]
            return np.concatenate([pad_left, x, pad_right])
        return np.concatenate([pad_left, x])[:new_num_samples]

    def _forward_items(self, items: Sequence[np.ndarray]) -> np.ndarray:
        """Prepare, zero-pad to the longest prepared item (at least one
        frame), run one forward, and return the (B, T, F) features on the
        host."""
        prepared = [self._prepare_item(s) for s in items]
        n = max(max(p.shape[-1] for p in prepared), self._frame_samples)
        batch = np.zeros((len(prepared), n), dtype=np.float32)
        for i, p in enumerate(prepared):
            batch[i, : p.shape[-1]] = p
        return self._forward_padded_batch(batch).cpu().numpy()

    def _check_rate(self, sampling_rate: int, method: str) -> None:
        if sampling_rate != self.config.sampling_rate:
            raise ValueError(
                f"{type(self).__name__} was instantiated for sampling_rate "
                f"{self.config.sampling_rate}, but sampling_rate={sampling_rate} was "
                f"passed to {method}(). Resample the audio first.")

    # ---- public API ----

    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        self._check_rate(sampling_rate, "extract")
        samples = np.asarray(samples, dtype=np.float32)
        squeeze = samples.ndim == 1
        if squeeze:
            samples = samples[None, :]
        samples = self._apply_dither(samples)
        num_frames = self._num_frames(samples.shape[1])
        out = self._forward_items(list(samples))[:, :num_frames]
        return out[0] if squeeze or out.shape[0] == 1 else out

    def extract_batch(
        self, samples: Union[np.ndarray, Sequence[np.ndarray]], sampling_rate: int,
        lengths: Optional[np.ndarray] = None) -> Union[np.ndarray, List[np.ndarray]]:
        """
        True batched extraction: collate variable-length inputs into one
        padded batch, run a single forward on the device, and slice each
        item to its own frame count, ``_num_frames(len)``.
        """
        self._check_rate(sampling_rate, "extract_batch")
        input_is_list = isinstance(samples, list)
        if lengths is not None:
            items = [np.asarray(s, dtype=np.float32)[: int(l)] for s, l in zip(samples, lengths)]
        elif input_is_list or getattr(samples, "ndim", 1) > 1:
            items = [np.asarray(s, dtype=np.float32).reshape(-1) for s in samples]
        else:
            items = [np.asarray(samples, dtype=np.float32).reshape(-1)]
        items = [self._apply_dither(s) for s in items]
        feats = self._forward_items(items)
        result = [feats[i, : self._num_frames(s.shape[-1])] for i, s in enumerate(items)]
        if len(result) == 1:
            return result if input_is_list else result[0]
        if all(r.shape == result[0].shape for r in result[1:]):
            return np.stack(result, axis=0)
        return result

    def extract_batch_collated(
        self,
        samples: Sequence[np.ndarray],
        sampling_rate: int,
        lengths: Optional[np.ndarray] = None,
        pad_value: float = 0.0,
    ) -> None:
        """The JAX package's in-place host route, which this device route
        does not have: returns None (callers use :meth:`extract_batch`)."""
        self._check_rate(sampling_rate, "extract_batch_collated")
        return None


@dataclass
class FbankConfig:
    sampling_rate: int = 16000
    frame_length: Seconds = 0.025
    frame_shift: Seconds = 0.01
    round_to_power_of_two: bool = True
    remove_dc_offset: bool = True
    preemph_coeff: float = 0.97
    window_type: str = "povey"
    dither: float = 0.0
    snip_edges: bool = False
    energy_floor: float = EPSILON
    raw_energy: bool = True
    use_energy: bool = False
    use_fft_mag: bool = False
    low_freq: float = 20.0
    high_freq: float = -400.0
    num_filters: int = 80
    num_mel_bins: Optional[int] = None  # do not use
    norm_filters: bool = False
    torchaudio_compatible_mel_scale: bool = True
    device: str = "cpu"

    def __post_init__(self):
        if self.num_mel_bins is not None:
            self.num_filters = self.num_mel_bins
            self.num_mel_bins = None
        if self.snip_edges:
            warnings.warn(
                "`snip_edges` is set to True, which may cause issues in duration "
                "to num-frames conversion."
            )

    def to_dict(self) -> Dict[str, Any]:
        return asdict_nonull(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "FbankConfig":
        return FbankConfig(**data)


class Fbank(_KaldiExtractorBase):
    name = "kaldi-fbank"
    config_type = FbankConfig
    _layer_type = Wav2LogFilterBank

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_filters

    def _postprocess(self, pow_spec, log_e):
        out = ops.mel_fbank_from_power(pow_spec, self.extractor._fb)
        if self.config.use_energy and log_e is not None:
            out = torch.cat([log_e[..., None], out], dim=-1)
        return out

    @staticmethod
    def mix(
        features_a: np.ndarray, features_b: np.ndarray, energy_scaling_factor_b: float,
    ) -> np.ndarray:
        return np.log(
            np.maximum(
                EPSILON,
                np.exp(features_a) + energy_scaling_factor_b * np.exp(features_b),
            )
        )

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        return float(np.sum(np.exp(features)))

    @staticmethod
    def scale(features: np.ndarray, energy_scaling_factor: float) -> np.ndarray:
        return features + np.log(energy_scaling_factor)


@dataclass
class MfccConfig:
    sampling_rate: int = 16000
    frame_length: Seconds = 0.025
    frame_shift: Seconds = 0.01
    round_to_power_of_two: bool = True
    remove_dc_offset: bool = True
    preemph_coeff: float = 0.97
    window_type: str = "povey"
    dither: float = 0.0
    snip_edges: bool = False
    energy_floor: float = EPSILON
    raw_energy: bool = True
    use_energy: bool = False
    use_fft_mag: bool = False
    low_freq: float = 20.0
    high_freq: float = -400.0
    num_filters: int = 23
    num_mel_bins: Optional[int] = None  # do not use
    norm_filters: bool = False
    num_ceps: int = 13
    cepstral_lifter: int = 22
    torchaudio_compatible_mel_scale: bool = True
    device: str = "cpu"

    def __post_init__(self):
        if self.num_mel_bins is not None:
            self.num_filters = self.num_mel_bins
            self.num_mel_bins = None

    def to_dict(self) -> Dict[str, Any]:
        return asdict_nonull(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "MfccConfig":
        return MfccConfig(**data)


class Mfcc(_KaldiExtractorBase):
    name = "kaldi-mfcc"
    config_type = MfccConfig
    _layer_type = Wav2MFCC

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_ceps

    def _postprocess(self, pow_spec, log_e):
        layer = self.extractor
        logmel = ops.mel_fbank_from_power(pow_spec, layer._fb)
        mfcc = ops.mfcc_from_logmel(logmel, layer._dct, layer._lifter)
        if self.config.use_energy and log_e is not None:
            mfcc[..., 0] = log_e
        return mfcc

    def _kernel_postprocess(self, logmel):
        return ops.mfcc_from_logmel(logmel, self.extractor._dct, self.extractor._lifter)


@dataclass
class SpectrogramConfig:
    sampling_rate: int = 16000
    frame_length: Seconds = 0.025
    frame_shift: Seconds = 0.01
    round_to_power_of_two: bool = True
    remove_dc_offset: bool = True
    preemph_coeff: float = 0.97
    window_type: str = "povey"
    dither: float = 0.0
    snip_edges: bool = False
    energy_floor: float = EPSILON
    raw_energy: bool = True
    use_energy: bool = False
    use_fft_mag: bool = False
    device: str = "cpu"

    def to_dict(self) -> Dict[str, Any]:
        return asdict_nonull(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "SpectrogramConfig":
        return SpectrogramConfig(**data)


class Spectrogram(_KaldiExtractorBase):
    name = "kaldi-spectrogram"
    config_type = SpectrogramConfig
    _layer_type = Wav2Spec

    def feature_dim(self, sampling_rate: int) -> int:
        return self._fft_length // 2 + 1

    def _postprocess(self, pow_spec, log_e):
        if self.config.use_energy and log_e is not None:
            pow_spec[..., 0] = log_e
        return pow_spec

    @staticmethod
    def mix(
        features_a: np.ndarray, features_b: np.ndarray, energy_scaling_factor_b: float,
    ) -> np.ndarray:
        return features_a + energy_scaling_factor_b * features_b

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        return float(np.sum(features))

    @staticmethod
    def scale(features: np.ndarray, energy_scaling_factor: float) -> np.ndarray:
        return features * energy_scaling_factor


@dataclass
class LogSpectrogramConfig:
    sampling_rate: int = 16000
    frame_length: Seconds = 0.025
    frame_shift: Seconds = 0.01
    round_to_power_of_two: bool = True
    remove_dc_offset: bool = True
    preemph_coeff: float = 0.97
    window_type: str = "povey"
    dither: float = 0.0
    snip_edges: bool = False
    energy_floor: float = EPSILON
    raw_energy: bool = True
    use_energy: bool = False
    use_fft_mag: bool = False
    device: str = "cpu"

    def to_dict(self) -> Dict[str, Any]:
        return asdict_nonull(self)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "LogSpectrogramConfig":
        return LogSpectrogramConfig(**data)


class LogSpectrogram(_KaldiExtractorBase):
    name = "kaldi-log-spectrogram"
    config_type = LogSpectrogramConfig
    _layer_type = Wav2LogSpec

    def feature_dim(self, sampling_rate: int) -> int:
        return self._fft_length // 2 + 1

    def _postprocess(self, pow_spec, log_e):
        out = torch.log(pow_spec + 1e-15)
        if self.config.use_energy and log_e is not None:
            out[..., 0] = log_e
        return out

    @staticmethod
    def mix(
        features_a: np.ndarray, features_b: np.ndarray, energy_scaling_factor_b: float,
    ) -> np.ndarray:
        return np.log(
            np.maximum(
                EPSILON,
                np.exp(features_a) + energy_scaling_factor_b * np.exp(features_b),
            )
        )

    @staticmethod
    def compute_energy(features: np.ndarray) -> float:
        return float(np.sum(np.exp(features)))

    @staticmethod
    def scale(features: np.ndarray, energy_scaling_factor: float) -> np.ndarray:
        return features + np.log(energy_scaling_factor)
