"""
Kaldi-compatible feature extraction layers as ``nn.Module`` s (port of
``lhotse_tpu/features/kaldi/layers.py``).

Each layer takes ``(batch, num_samples)`` (or ``(num_samples,)``) float32
audio and keeps its constant matrices as registered buffers, created on the
``device`` given to the constructor: the card (``"cuda"``) unless the caller
asks for another, as the CPU tests do with ``device="cpu"``. ``Wav2LogFilterBank`` and ``Wav2MFCC``
route every configuration that maps onto the fused fbank kernel (400-sample
frames, 160-sample hop, 512-point FFT, no energy column, power spectrum,
zero Nyquist mel row) to :func:`lhotse_tpu_torch.ops.fbank_cuda.fbank_fused_padded`,
on every device; other configurations take the plain path, as in JAX. The
mel bank goes to the kernel at its own width (80, or 23 for MFCC).

Dither draws from the ``torch.Generator`` given to the constructor; a layer
with ``dither != 0`` and no generator is refused.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from lhotse_tpu_torch.ops import fbank as ops
from lhotse_tpu_torch.ops import fbank_cuda
from lhotse_tpu_torch.ops.fbank import (
    EPSILON, available_windows, create_frame_window, create_mel_scale, get_mel_banks, lin2mel,
    mel2lin, next_power_of_2)

__all__ = [
    "Wav2Win", "Wav2FFT", "Wav2Spec", "Wav2LogSpec", "Wav2LogFilterBank", "Wav2MFCC",
    "available_windows", "create_frame_window", "create_mel_scale", "get_mel_banks", "lin2mel",
    "mel2lin", "next_power_of_2"]

Seconds = float


def _as_batch(x, device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.ndim == 1:
        x = x[None, :]
    return x


def _get_strided_batch_streaming(
    waveform: torch.Tensor, window_shift: int, window_length: int,
    prev_remainder: Optional[torch.Tensor] = None,
    snip_edges: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Streaming framing: accepts optional leftover samples from the previous
    call, returns (frames, remainder).
    """
    assert window_shift <= window_length
    assert waveform.ndim == 2
    batch_size = waveform.shape[0]
    if prev_remainder is None:
        if not snip_edges:
            npad_left = (window_length - window_shift) // 2
            waveform = torch.cat([waveform[:, :npad_left].flip(-1), waveform], dim=1)
    else:
        assert prev_remainder.ndim == 2
        assert prev_remainder.shape[0] == batch_size
        waveform = torch.cat([prev_remainder, waveform], dim=1)

    num_samples = waveform.shape[-1]
    if snip_edges:
        if num_samples < window_length:
            return waveform.new_empty((batch_size, 0, 0)), waveform
        num_frames = 1 + (num_samples - window_length) // window_shift
    else:
        window_remainder = window_length - window_shift
        num_frames = (num_samples - window_remainder) // window_shift
    remainder = waveform[:, num_frames * window_shift:]
    if num_frames <= 0:
        return waveform.new_zeros((batch_size, 0, window_length)), remainder
    frames = waveform.unfold(-1, window_length, window_shift)[:, :num_frames]
    return frames, remainder


class Wav2Win(nn.Module):
    """
    Dithering, DC-offset removal, pre-emphasis, windowing, and partitioning
    into overlapping frames of audio samples — output is still time-domain,
    shape ``(batch, num_frames, window_length)`` (+ optional log-energy).
    """

    def __init__(
        self, sampling_rate: int = 16000, frame_length: Seconds = 0.025,
        frame_shift: Seconds = 0.01, pad_length: Optional[int] = None,
        remove_dc_offset: bool = True, preemph_coeff: float = 0.97, window_type: str = "povey",
        dither: float = 0.0, snip_edges: bool = False, energy_floor: float = EPSILON,
        raw_energy: bool = True, return_log_energy: bool = False,
        generator: Optional[torch.Generator] = None, device="cuda") -> None:
        super().__init__()
        if dither != 0.0 and generator is None:
            raise ValueError("dither != 0 needs a torch.Generator (generator=...) to draw from.")
        self.sampling_rate = sampling_rate
        self.frame_length = frame_length
        self.frame_shift = frame_shift
        self.remove_dc_offset = remove_dc_offset
        self.preemph_coeff = preemph_coeff
        self.window_type = window_type
        self.dither = dither
        self.generator = generator
        self.snip_edges = snip_edges
        self.energy_floor = energy_floor
        self.raw_energy = raw_energy
        self.return_log_energy = return_log_energy
        if snip_edges:
            import warnings

            warnings.warn(
                "Setting snip_edges=True is generally incompatible with this library "
                "-- you might experience mismatched duration/num_frames errors."
            )
        N = int(math.floor(frame_length * sampling_rate))
        self._length = N
        self._shift = int(math.floor(frame_shift * sampling_rate))
        self.register_buffer("_window", torch.as_tensor(
            create_frame_window(N, window_type=window_type).astype(np.float32), device=device))
        self.pad_length = N if pad_length is None else pad_length
        assert self.pad_length >= N, (
            f"pad_length (or fft_length) = {pad_length} cannot be smaller than N = {N}"
        )

    def extra_repr(self) -> str:
        return (
            f"sampling_rate={self.sampling_rate}, frame_length={self.frame_length}, "
            f"frame_shift={self.frame_shift}, pad_length={self.pad_length}, "
            f"remove_dc_offset={self.remove_dc_offset}, preemph_coeff={self.preemph_coeff}, "
            f"window_type={self.window_type}, dither={self.dither}, "
            f"snip_edges={self.snip_edges}, energy_floor={self.energy_floor}, "
            f"raw_energy={self.raw_energy}, return_log_energy={self.return_log_energy}"
        )

    def _maybe_dither(self, x: torch.Tensor) -> torch.Tensor:
        if self.dither != 0.0:
            noise = torch.randn(x.shape, generator=self.generator, dtype=x.dtype, device=x.device)
            return x + self.dither * noise
        return x

    def _forward_strided(self, x_strided: torch.Tensor):
        if self.remove_dc_offset:
            x_strided = x_strided - torch.mean(x_strided, dim=2, keepdim=True)
        log_energy = None
        if self.return_log_energy and self.raw_energy:
            log_energy = ops.frame_log_energy(x_strided, self.energy_floor)
        if self.preemph_coeff != 0.0:
            prev = torch.cat([x_strided[..., :1], x_strided[..., :-1]], dim=-1)
            x_strided = x_strided - self.preemph_coeff * prev
        x_strided = x_strided * self._window
        if self.pad_length != self._length:
            x_strided = nn.functional.pad(x_strided, (0, self.pad_length - self._length))
        if self.return_log_energy and not self.raw_energy:
            log_energy = ops.frame_log_energy(x_strided, self.energy_floor)
        return x_strided, log_energy

    def forward(self, x):
        x = self._maybe_dither(_as_batch(x, self._window.device))
        x_strided = ops.frame_signal(x, self._length, self._shift, self.snip_edges)
        return self._forward_strided(x_strided)

    def online_inference(self, x, context: Optional[torch.Tensor] = None):
        """Streaming variant: returns ``((frames, log_energy), remainder)``."""
        x = self._maybe_dither(_as_batch(x, self._window.device))
        x_strided, remainder = _get_strided_batch_streaming(
            x, window_shift=self._shift, window_length=self._length, prev_remainder=context,
            snip_edges=self.snip_edges)
        return self._forward_strided(x_strided), remainder


class Wav2FFT(nn.Module):
    """
    Preprocess waveforms and compute their STFT; output is complex64 of shape
    ``(batch, num_frames, num_fft_bins)``. When ``use_energy``, bin 0 is
    replaced with the frame log-energy.
    """

    def __init__(
        self, sampling_rate: int = 16000, frame_length: Seconds = 0.025,
        frame_shift: Seconds = 0.01, round_to_power_of_two: bool = True,
        remove_dc_offset: bool = True, preemph_coeff: float = 0.97, window_type: str = "povey",
        dither: float = 0.0, snip_edges: bool = False, energy_floor: float = EPSILON,
        raw_energy: bool = True, use_energy: bool = True,
        generator: Optional[torch.Generator] = None, device="cuda") -> None:
        super().__init__()
        self.use_energy = use_energy
        N = int(math.floor(frame_length * sampling_rate))
        self.fft_length = next_power_of_2(N) if round_to_power_of_two else N
        self.wav2win = Wav2Win(
            sampling_rate, frame_length, frame_shift, pad_length=self.fft_length,
            remove_dc_offset=remove_dc_offset, preemph_coeff=preemph_coeff, window_type=window_type,
            dither=dither, snip_edges=snip_edges, energy_floor=energy_floor, raw_energy=raw_energy,
            return_log_energy=use_energy, generator=generator, device=device)

    @property
    def sampling_rate(self) -> int:
        return self.wav2win.sampling_rate

    @property
    def frame_length(self) -> Seconds:
        return self.wav2win.frame_length

    @property
    def frame_shift(self) -> Seconds:
        return self.wav2win.frame_shift

    @property
    def remove_dc_offset(self) -> bool:
        return self.wav2win.remove_dc_offset

    @property
    def preemph_coeff(self) -> float:
        return self.wav2win.preemph_coeff

    @property
    def window_type(self) -> str:
        return self.wav2win.window_type

    @property
    def dither(self) -> float:
        return self.wav2win.dither

    @property
    def device(self) -> torch.device:
        return self.wav2win._window.device

    def _forward_strided(self, x_strided: torch.Tensor, log_e: Optional[torch.Tensor]):
        X = torch.fft.rfft(x_strided, dim=-1)
        if self.use_energy and log_e is not None:
            X[:, :, 0] = log_e.to(X.dtype)
        return X

    def forward(self, x):
        x_strided, log_e = self.wav2win(x)
        return self._forward_strided(x_strided, log_e)

    def online_inference(self, x, context: Optional[torch.Tensor] = None):
        (x_strided, log_e), remainder = self.wav2win.online_inference(x, context=context)
        return self._forward_strided(x_strided, log_e), remainder


class _GemmSpectrum(Wav2FFT):
    """Holds the plain DFT matrices of the GEMM power spectrum: frames are
    already preprocessed and padded to ``fft_length``."""

    def _register_dft(self, device) -> None:
        C, S = ops.raw_dft_matrices(self.fft_length, self.fft_length)
        self.register_buffer("_C", torch.as_tensor(C, device=device), persistent=False)
        self.register_buffer("_S", torch.as_tensor(S, device=device), persistent=False)

    def _power(self, x_strided: torch.Tensor) -> torch.Tensor:
        return ops.power_spectrum_gemm(x_strided, self._C, self._S, use_fft_mag=self.use_fft_mag)


class Wav2Spec(_GemmSpectrum):
    """STFT magnitude (``use_fft_mag=True``) or power spectrum."""

    def __init__(
        self, sampling_rate: int = 16000, frame_length: Seconds = 0.025,
        frame_shift: Seconds = 0.01, round_to_power_of_two: bool = True,
        remove_dc_offset: bool = True, preemph_coeff: float = 0.97, window_type: str = "povey",
        dither: float = 0.0, snip_edges: bool = False, energy_floor: float = EPSILON,
        raw_energy: bool = True, use_energy: bool = True, use_fft_mag: bool = False,
        generator: Optional[torch.Generator] = None, device="cuda") -> None:
        super().__init__(
            sampling_rate, frame_length, frame_shift, round_to_power_of_two=round_to_power_of_two,
            remove_dc_offset=remove_dc_offset, preemph_coeff=preemph_coeff, window_type=window_type,
            dither=dither, snip_edges=snip_edges, energy_floor=energy_floor, raw_energy=raw_energy,
            use_energy=use_energy, generator=generator, device=device)
        self.use_fft_mag = use_fft_mag
        self._register_dft(device)

    def _forward_strided(self, x_strided, log_e):
        pow_spec = self._power(x_strided)
        if self.use_energy and log_e is not None:
            pow_spec[:, :, 0] = log_e
        return pow_spec


class Wav2LogSpec(Wav2Spec):
    """Log-magnitude or log-power spectrum (log(spec + 1e-15))."""

    def _forward_strided(self, x_strided, log_e):
        pow_spec = torch.log(self._power(x_strided) + 1e-15)
        if self.use_energy and log_e is not None:
            pow_spec[:, :, 0] = log_e
        return pow_spec


class _MelBase(_GemmSpectrum):
    """Shared mel-filterbank construction and fused-kernel routing for the
    fbank/MFCC layers. Buffers: ``_fb`` (bins, num_filters) and, when the
    configuration maps onto the kernel, ``Mc``/``Ms`` (400, 257) — the same
    arrays the JAX layer holds as ``_fb`` and ``_fused_matrices()[:2]``."""

    def _build_fb(
        self, num_filters: int, sampling_rate: int, low_freq: float, high_freq: float,
        norm_filters: bool, torchaudio_compatible_mel_scale: bool) -> np.ndarray:
        if torchaudio_compatible_mel_scale:
            fb, _ = get_mel_banks(
                num_bins=num_filters, window_length_padded=self.fft_length,
                sample_freq=sampling_rate, low_freq=low_freq, high_freq=high_freq)
            # Zero-pad the nyquist bin column and transpose to (bins, filters).
            fb = np.pad(fb, ((0, 0), (0, 1))).T
        else:
            fb = create_mel_scale(
                num_filters=num_filters, fft_length=self.fft_length, sampling_rate=sampling_rate,
                low_freq=low_freq, high_freq=high_freq, norm_filters=norm_filters)
        return fb.astype(np.float32)

    def _register_mel(self, fb: np.ndarray, device) -> None:
        """Register ``_fb`` and, for a configuration the kernel takes, the
        folded analysis matrices ``Mc``/``Ms``."""
        self._register_dft(device)
        self.register_buffer("_fb", torch.as_tensor(fb, device=device))
        w = self.wav2win
        self._fused = (
            w._length == 400
            and w._shift == 160
            and self.fft_length == 512
            and not self.use_energy
            and not self.use_fft_mag
            and fb.shape[0] == 257
            and not fb[256].any()
        )
        if self._fused:
            Mc, Ms = ops.dft_analysis_matrices(
                w._length, self.fft_length, window_type=w.window_type,
                remove_dc_offset=w.remove_dc_offset, preemph_coeff=w.preemph_coeff)
            self.register_buffer("Mc", torch.as_tensor(Mc, device=device))
            self.register_buffer("Ms", torch.as_tensor(Ms, device=device))
            self._refresh_fused()

    def _refresh_fused(self) -> None:
        """(Re)derive the kernel's 256-bin matrices from ``Mc``/``Ms``/``_fb``
        and the kernel's packed operand ``_fused_dft``: contiguous
        non-persistent buffers, so the forward pass neither copies nor checks
        the Nyquist row (which would wait for the device)."""
        if not self._fused:
            return
        Mc, Ms, fb = fbank_cuda._squeeze_nyquist(self.Mc, self.Ms, self._fb)
        for name, t in (("_fused_Mc", Mc), ("_fused_Ms", Ms), ("_fused_fb", fb)):
            self.register_buffer(name, t.contiguous().clone(), persistent=False)
        self.register_buffer("_fused_dft", fbank_cuda.pack_dft(Mc, Ms), persistent=False)

    def _fused_matrices(self):
        """(Mc, Ms, fb, n_mels) as the fused kernel takes them (256 bins,
        ``fb`` at its own width), or None when this configuration does not
        map onto it."""
        if not self._fused:
            return None
        return self._fused_Mc, self._fused_Ms, self._fused_fb, self._fused_fb.shape[1]

    def _fused_logmel(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Log-mel through the fused kernel route, or None when the
        configuration does not map onto it."""
        mats = self._fused_matrices()
        if mats is None:
            return None
        Mc, Ms, fb, _ = mats
        # Dithering applies to the raw waveform exactly as in Wav2Win.forward;
        # DC-removal/pre-emphasis/window are folded into the analysis matrices.
        dithered = self.wav2win._maybe_dither(x)
        return fbank_cuda.fbank_fused_padded(
            dithered, Mc, Ms, fb, snip_edges=self.wav2win.snip_edges, dft=self._fused_dft)


class Wav2LogFilterBank(_MelBase):
    """
    Log-Mel filterbank energies ("fbank"): shape (batch, num_frames,
    num_filters); with ``use_energy`` the log-energy is prepended as an extra
    first column.
    """

    def __init__(
        self, sampling_rate: int = 16000, frame_length: Seconds = 0.025,
        frame_shift: Seconds = 0.01, round_to_power_of_two: bool = True,
        remove_dc_offset: bool = True, preemph_coeff: float = 0.97, window_type: str = "povey",
        dither: float = 0.0, snip_edges: bool = False, energy_floor: float = EPSILON,
        raw_energy: bool = True, use_energy: bool = False, use_fft_mag: bool = False,
        low_freq: float = 20.0, high_freq: float = -400.0, num_filters: int = 80,
        norm_filters: bool = False, torchaudio_compatible_mel_scale: bool = True,
        generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__(
            sampling_rate, frame_length, frame_shift, round_to_power_of_two=round_to_power_of_two,
            remove_dc_offset=remove_dc_offset, preemph_coeff=preemph_coeff, window_type=window_type,
            dither=dither, snip_edges=snip_edges, energy_floor=energy_floor, raw_energy=raw_energy,
            use_energy=use_energy, generator=generator, device=device)
        self.use_fft_mag = use_fft_mag
        self.low_freq = low_freq
        self.high_freq = high_freq
        self.num_filters = num_filters
        self.norm_filters = norm_filters
        self._register_mel(self._build_fb(
            num_filters, sampling_rate, low_freq, high_freq, norm_filters,
            torchaudio_compatible_mel_scale), device)

    def _forward_strided(self, x_strided, log_e):
        logmel = ops.mel_fbank_from_power(self._power(x_strided), self._fb)
        if self.use_energy and log_e is not None:
            logmel = torch.cat([log_e[..., None], logmel], dim=-1)
        return logmel

    def forward(self, x):
        x = _as_batch(x, self.device)
        logmel = self._fused_logmel(x)
        return logmel if logmel is not None else super().forward(x)


class Wav2MFCC(_MelBase):
    """Mel-frequency cepstral coefficients: (batch, num_frames, num_ceps)."""

    def __init__(
        self, sampling_rate: int = 16000, frame_length: Seconds = 0.025,
        frame_shift: Seconds = 0.01, round_to_power_of_two: bool = True,
        remove_dc_offset: bool = True, preemph_coeff: float = 0.97, window_type: str = "povey",
        dither: float = 0.0, snip_edges: bool = False, energy_floor: float = EPSILON,
        raw_energy: bool = True, use_energy: bool = False, use_fft_mag: bool = False,
        low_freq: float = 20.0, high_freq: float = -400.0, num_filters: int = 23,
        norm_filters: bool = False, num_ceps: int = 13, cepstral_lifter: int = 22,
        torchaudio_compatible_mel_scale: bool = True,
        generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__(
            sampling_rate, frame_length, frame_shift, round_to_power_of_two=round_to_power_of_two,
            remove_dc_offset=remove_dc_offset, preemph_coeff=preemph_coeff, window_type=window_type,
            dither=dither, snip_edges=snip_edges, energy_floor=energy_floor, raw_energy=raw_energy,
            use_energy=use_energy, generator=generator, device=device)
        self.use_fft_mag = use_fft_mag
        self.low_freq = low_freq
        self.high_freq = high_freq
        self.num_filters = num_filters
        self.norm_filters = norm_filters
        self.num_ceps = num_ceps
        self.cepstral_lifter = cepstral_lifter
        self._register_mel(self._build_fb(
            num_filters, sampling_rate, low_freq, high_freq, norm_filters,
            torchaudio_compatible_mel_scale), device)
        self.register_buffer("_dct", torch.as_tensor(
            ops.make_dct_matrix(num_ceps, num_filters).astype(np.float32), device=device))
        self.register_buffer("_lifter", torch.as_tensor(
            ops.make_lifter(num_ceps, cepstral_lifter).astype(np.float32), device=device)
            if cepstral_lifter > 0 else None)

    @staticmethod
    def make_lifter(N: int, Q: int):
        return ops.make_lifter(N, Q)

    @staticmethod
    def make_dct_matrix(num_ceps: int, num_filters: int):
        return ops.make_dct_matrix(num_ceps, num_filters)

    def _forward_strided(self, x_strided, log_e):
        logmel = ops.mel_fbank_from_power(self._power(x_strided), self._fb)
        mfcc = ops.mfcc_from_logmel(logmel, self._dct, self._lifter)
        if self.use_energy and log_e is not None:
            mfcc[..., 0] = log_e
        return mfcc

    def forward(self, x):
        x = _as_batch(x, self.device)
        logmel = self._fused_logmel(x)
        if logmel is None:
            return super().forward(x)
        # Fused log-mel, then the small DCT + lifter products.
        return ops.mfcc_from_logmel(logmel, self._dct, self._lifter)
