"""
Batched augmentation ops and the augment→fbank pipeline as PyTorch ops
(port of ``lhotse_tpu/ops/augment.py``).

Every op consumes a fixed-shape ``(B, T)`` bucket with a ``lens`` vector
instead of ragged per-cut arrays, and runs on the device of its input
tensors:

- SNR noise-mix gain ``sqrt(E_ref * 10^(-snr/10) / E_noise)``;
- RIR reverberation by FFT convolution with Kaldi ``--shift-output``
  semantics (output aligned at the RIR peak, length == input) and energy
  normalization;
- the SpecAugment apply step (interp gather + masked fill).

:func:`make_augment_fbank_pipeline` chains wire decode → speed perturb →
volume gain → SNR noise mix → RIR reverb → fbank → SpecAugment as one plain
Python function. PyTorch runs it eagerly; the fbank step is the hand-written
CUDA kernel for a CUDA tensor (:mod:`lhotse_tpu_torch.ops.fbank_cuda`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank
from lhotse_tpu_torch.ops.resample import resampled_num_samples, speed_perturb
from lhotse_tpu_torch.ops.wire import decode_wire

RIR_SCALING_FACTOR = 0.5**15  # the host reverb path's tap scaling


def _on(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (tensor, numpy array or scalar) as a tensor on ``device``."""
    return torch.as_tensor(x, dtype=dtype, device=device)


def valid_mask(lens: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B,) lens → (B, num_samples) float32 0/1 mask."""
    arange = torch.arange(num_samples, device=lens.device)
    return (arange[None, :] < lens[:, None]).to(torch.float32)


def masked_energy(audio: torch.Tensor, lens=None) -> torch.Tensor:
    """
    Per-item mean power over the valid samples (mean of x^2). With
    ``lens=None`` the full last axis counts.
    """
    if lens is None:
        return torch.mean(audio * audio, dim=-1)
    lens = _on(lens, audio.device)
    mask = valid_mask(lens, audio.shape[-1])
    denom = torch.clamp_min(lens.to(torch.float32), 1.0)
    return torch.sum(audio * audio * mask, dim=-1) / denom


def snr_mix_gain(ref_energy: torch.Tensor, noise_energy: torch.Tensor, snr) -> torch.Tensor:
    """
    Batched SNR gain: ``sqrt(E_ref * 10^(-snr/10) / E_noise)``, falling back
    to 1.0 when either energy is non-positive.
    """
    device = ref_energy.device
    ref_energy = ref_energy.to(torch.float32)
    noise_energy = noise_energy.to(torch.float32)
    snr = _on(snr, device, torch.float32)
    target = ref_energy * torch.pow(10.0, -snr / 10.0)
    gain = torch.sqrt(target / torch.clamp_min(noise_energy, 1e-20))
    return torch.where((ref_energy > 0) & (noise_energy > 0), gain, 1.0)


def place_at_offsets(noise: torch.Tensor, noise_lens, offsets, num_samples: int) -> torch.Tensor:
    """
    Shift each noise row so it starts at ``offsets[b]`` samples within a
    ``num_samples``-long frame, zero outside ``[offset, offset+len)``.
    """
    device = noise.device
    offsets = _on(offsets, device, torch.int64)
    idx = torch.arange(num_samples, device=device)[None, :] - offsets[:, None]
    ok = (idx >= 0) & (idx < _on(noise_lens, device)[:, None])
    gathered = torch.gather(noise, -1, idx.clamp(0, noise.shape[-1] - 1))
    return torch.where(ok, gathered, 0.0)


def mix_noise(
    audio: torch.Tensor,
    audio_lens,
    noise: torch.Tensor,
    noise_lens=None,
    snr=10.0,
    offsets=None,
    mix_mask=None,
    reference_energy=None,
) -> torch.Tensor:
    """
    Mix a noise batch into an audio batch at the requested per-item SNRs:
    ``mixed = audio + gain * shift(noise)`` truncated to the audio frame.

    :param audio: (B, T) batch; valid lengths ``audio_lens``.
    :param noise: (B, Tn) noise batch; valid lengths ``noise_lens``.
    :param snr: scalar or (B,) target SNR in dB (noise relative to audio).
    :param offsets: optional (B,) sample offsets where each noise starts.
    :param mix_mask: optional (B,) 0/1 — items with 0 pass through unmixed
        (the batched form of ``mix_prob``).
    :param reference_energy: optional (B,) override of the audio energy used
        in the gain (e.g. the pre-gain energy of a MixedCut's first track).
    """
    device = audio.device
    T = audio.shape[-1]
    ref_energy = (
        masked_energy(audio, audio_lens)
        if reference_energy is None
        else _on(reference_energy, device, torch.float32)
    )
    noise = _on(noise, device)
    noise_energy = masked_energy(noise, noise_lens)
    gain = snr_mix_gain(ref_energy, noise_energy, snr)
    if offsets is None:
        # Gather-free path: align at t=0, mask/pad/truncate to T.
        placed = noise
        if noise_lens is not None:
            placed = placed * valid_mask(_on(noise_lens, device), placed.shape[-1])
        if placed.shape[-1] < T:
            placed = F.pad(placed, (0, T - placed.shape[-1]))
        elif placed.shape[-1] > T:
            placed = placed[:, :T]
    else:
        lens = (
            torch.full((audio.shape[0],), noise.shape[-1], device=device)
            if noise_lens is None
            else noise_lens
        )
        placed = place_at_offsets(noise, lens, offsets, T)
    if mix_mask is not None:
        gain = gain * _on(mix_mask, device, torch.float32)
    return audio + gain[:, None] * placed


def reverb_rir(audio: torch.Tensor, rir, audio_lens=None, rir_lens=None,
               normalize: bool = True) -> torch.Tensor:
    """
    Batched RIR reverberation with Kaldi ``wav-reverberate --shift-output``
    semantics: full FFT convolution with ``rir * 2^-15``, output realigned
    so the RIR peak lands at t=0, truncated to the input length, optionally
    rescaled to preserve the dry energy.

    :param audio: (B, T); ``audio_lens`` marks valid samples (tail beyond an
        item's length is cut).
    :param rir: (L,) shared or (B, L) per-item impulse responses;
        ``rir_lens`` masks per-item padding in a batched RIR. A 1-D numpy
        RIR (the build-time RIR of the pipeline) has its peak found on the
        host, and the realignment is a plain slice with one shared FFT row;
        a tensor RIR is realigned on the device by argmax + gather.
    """
    device = audio.device
    audio = audio.to(torch.float32)
    B, T = audio.shape
    static_peak = None
    if isinstance(rir, np.ndarray) and rir.ndim == 1 and rir_lens is None:
        static_peak = int(np.argmax(rir))
    rir = _on(rir, device, torch.float32)
    if rir.ndim == 1:
        if static_peak is not None:
            # Shared RIR: one FFT row, broadcast in the frequency product.
            rir = rir[None, :]
        else:
            rir = rir[None, :].expand(B, rir.shape[0])
    L = rir.shape[-1]
    if rir_lens is not None:
        rir = rir * valid_mask(_on(rir_lens, device), L)
    taps = rir * RIR_SCALING_FACTOR

    full = T + L - 1
    fft_size = 1 << (full - 1).bit_length()
    wet_full = torch.fft.irfft(
        torch.fft.rfft(audio, n=fft_size) * torch.fft.rfft(taps, n=fft_size), n=fft_size)
    # Align the RIR peak with t=0 (host: wet[peak : peak + N]).
    if static_peak is not None:
        wet = wet_full[:, static_peak : static_peak + T]
    else:
        peak = torch.argmax(taps, dim=-1)
        idx = peak[:, None] + torch.arange(T, device=device)[None, :]
        wet = torch.gather(wet_full, -1, idx.clamp(0, fft_size - 1))
    if audio_lens is not None:
        wet = wet * valid_mask(_on(audio_lens, device), T)
    if normalize:
        dry_power = masked_energy(audio, audio_lens)
        wet_power = masked_energy(wet, audio_lens)
        scale = torch.sqrt(dry_power / torch.clamp_min(wet_power, 1e-20))
        wet = wet * torch.where(wet_power > 0, scale, 1.0)[:, None]
    return wet


def resolve_fbank_layer(fbank, sampling_rate: int, device):
    """
    Normalize the ``fbank`` argument of the pipeline to a batched
    wav->features layer: ``None`` -> a default
    :class:`~lhotse_tpu_torch.features.kaldi.layers.Wav2LogFilterBank` on
    ``device``; any other callable (such as a layer of
    :mod:`lhotse_tpu_torch.features.kaldi.layers`) passes through.
    """
    if fbank is None:
        return Wav2LogFilterBank(sampling_rate=sampling_rate, device=device)
    if not callable(fbank):
        raise ValueError(
            f"{type(fbank).__name__} is not a batched wav->features layer; pass a "
            "callable such as lhotse_tpu_torch's Wav2LogFilterBank instead.")
    return fbank


def apply_specaugment(features: torch.Tensor, warp_src: torch.Tensor, time_mask: torch.Tensor,
                      freq_mask: torch.Tensor) -> torch.Tensor:
    """
    Vectorized SpecAugment apply on ``(B, T, F)`` features: linear-interp
    gather along time by fractional source indices ``warp_src`` (B, T), then
    masked fill with per-example means. The randomness lives in
    :class:`lhotse_tpu_torch.dataset.signal_transforms.SpecAugment`
    (host-side, checkpointable) — this is only the math.
    """
    b, t, f = features.shape
    src = warp_src.to(torch.float32)
    lo = torch.clamp(torch.floor(src).to(torch.int64), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    frac = (src - lo.to(torch.float32))[..., None]
    batch_idx = torch.arange(b, device=features.device)[:, None]
    gathered = (1.0 - frac) * features[batch_idx, lo] + frac * features[batch_idx, hi]

    mean = gathered.mean(dim=(1, 2), keepdim=True)
    masked = time_mask[:, :, None] | freq_mask[:, None, :]
    return torch.where(masked, mean, gathered).to(features.dtype)


def make_augment_fbank_pipeline(
    sampling_rate: int = 16000,
    speed_factor: Optional[float] = None,
    normalize_rir: bool = True,
    fbank=None,
    wire_format: str = "float32",
    rir: Optional[np.ndarray] = None,
    *,
    device,
):
    """
    Build the full augment→fbank chain over a fixed-shape bucket on
    ``device``:

        wire decode → speed perturb → volume gain → SNR noise mix → RIR
        reverb → fbank [→ SpecAugment warp + masks]

    Every stage is optional at call time (pass ``None`` to skip). Returns a
    plain function ``fn(audio, audio_lens, *, gains, noise, noise_lens, snr,
    noise_offsets, mix_mask, rir, warp_src, time_mask, freq_mask) -> (feats
    (B, T', 80), feat_lens (B,))``; its arguments may be tensors or numpy
    arrays, and numpy arrays are copied to ``device``. ``wire_format``
    selects the host->device audio encoding (:mod:`lhotse_tpu_torch.ops.wire`).

    A fixed impulse response should be passed HERE (build-time ``rir``,
    numpy) rather than per call: its peak is found once on the host and the
    realignment is a slice with one shared FFT row. A per-call ``rir``
    overrides it and is realigned on the device by argmax + gather.
    """
    device = torch.device(device)
    fbank = resolve_fbank_layer(fbank, sampling_rate, device)
    hop = round(fbank.frame_shift * sampling_rate)
    static_rir = None if rir is None else np.asarray(rir, np.float32)

    def pipeline(
        audio,
        audio_lens,
        gains=None,
        noise=None,
        noise_lens=None,
        snr=None,
        noise_offsets=None,
        mix_mask=None,
        rir=None,
        warp_src=None,
        time_mask=None,
        freq_mask=None,
    ):
        audio = decode_wire(_on(audio, device), wire_format)
        audio_lens = _on(audio_lens, device, torch.int64)
        if speed_factor is not None and speed_factor != 1.0:
            orig = round(sampling_rate * speed_factor)
            audio = speed_perturb(audio, speed_factor, sampling_rate)
            audio_lens = resampled_num_samples(audio_lens, orig, sampling_rate)
        if gains is not None:
            audio = audio * _on(gains, device, torch.float32)[:, None]
        if noise is not None:
            audio = mix_noise(
                audio,
                audio_lens,
                noise,
                noise_lens,
                snr,
                offsets=noise_offsets,
                mix_mask=mix_mask,
            )
        if rir is None:
            rir = static_rir  # numpy -> static-peak path (see docstring)
        if rir is not None:
            audio = reverb_rir(audio, rir, audio_lens=audio_lens, normalize=normalize_rir)
        feats = fbank(audio)
        # snip_edges=False frame count, computed per item from the lens.
        feat_lens = (audio_lens + hop // 2) // hop
        if time_mask is not None or freq_mask is not None or warp_src is not None:
            # Host draws use the analytic frame-count formula, which may
            # overshoot the layer's actual output by a frame — slice down.
            B, T_f, F_ = feats.shape
            if warp_src is None:
                warp_src = torch.arange(T_f, dtype=torch.float32, device=device)[None, :].expand(
                    B, T_f)
            else:
                warp_src = _on(warp_src, device)[:, :T_f]
            if time_mask is None:
                time_mask = torch.zeros((B, T_f), dtype=torch.bool, device=device)
            else:
                time_mask = _on(time_mask, device)[:, :T_f]
            if freq_mask is None:
                freq_mask = torch.zeros((B, F_), dtype=torch.bool, device=device)
            else:
                freq_mask = _on(freq_mask, device)
            feats = apply_specaugment(feats, warp_src, time_mask, freq_mask)
        return feats, feat_lens

    return pipeline
