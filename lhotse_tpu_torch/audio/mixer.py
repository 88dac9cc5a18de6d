"""
AudioMixer: combine multiple tracks into one signal (copied from
``lhotse_tpu/audio/mixer.py``). One mixer per MixedCut; tracks are added
with time offsets and SNRs relative to the reference track's energy; the
SNR gain is ``sqrt(E_ref * 10^(-snr/10) / E_add)`` since time-domain signals
are root-power quantities. Multi-channel rules: a mono track mixes into
every channel; two multi-channel tracks must have equal channel counts.
``VideoMixer`` is not ported.
"""
from __future__ import annotations

from math import sqrt
from typing import List, Optional

import numpy as np

from lhotse_tpu_torch.utils import Decibels, Seconds, compute_num_samples


def audio_energy(audio: np.ndarray) -> float:
    return float(np.average(audio**2))


class AudioMixer:
    """
    Mix multiple waveforms into one. Initialized with the reference signal
    (C, N); other signals are added with ``add_to_mix(audio, snr, offset)``.
    """

    def __init__(
        self, base_audio: np.ndarray, sampling_rate: int, reference_energy: Optional[float] = None,
        base_offset: Seconds = 0.0):
        self.sampling_rate = sampling_rate
        self.tracks = [base_audio]
        self.offsets = [compute_num_samples(base_offset, sampling_rate)]
        self.num_channels, self.dtype = base_audio.shape[0], base_audio.dtype
        self.reference_energy = (
            audio_energy(base_audio) if reference_energy is None else reference_energy
        )

    def _pad_track(self, audio: np.ndarray, offset: int, total: Optional[int] = None) -> np.ndarray:
        assert audio.ndim == 2, f"audio.ndim={audio.ndim}"
        if total is None:
            total = audio.shape[1] + offset
        assert audio.shape[1] + offset <= total
        return np.pad(audio, pad_width=((0, 0), (offset, total - audio.shape[1] - offset)))

    @property
    def num_samples_total(self) -> int:
        return max(
            (offset + audio.shape[1] for offset, audio in zip(self.offsets, self.tracks)),
            default=0)

    @property
    def unmixed_audio(self) -> List[np.ndarray]:
        """Each track zero-padded/scaled to the mix length: list of (C, N)."""
        total = self.num_samples_total
        return [
            self._pad_track(track, offset=offset, total=total) for offset,
            track in zip(self.offsets, self.tracks)]

    @property
    def mixed_audio(self) -> np.ndarray:
        """Per-channel mix: (num_channels, num_samples); mono tracks are
        broadcast into every channel."""
        total = self.num_samples_total
        mixed = np.zeros((self.num_channels, total), dtype=self.dtype)
        for offset, track in zip(self.offsets, self.tracks):
            if track.shape[0] == 1 and self.num_channels > 1:
                track = np.tile(track, (self.num_channels, 1))
            mixed[:, offset : offset + track.shape[1]] += track
        return mixed

    @property
    def mixed_mono_audio(self) -> np.ndarray:
        """All channels downmixed together: (1, num_samples)."""
        total = self.num_samples_total
        mixed = np.zeros((1, total), dtype=self.dtype)
        for offset, track in zip(self.offsets, self.tracks):
            if track.shape[0] > 1:
                track = np.sum(track, axis=0, keepdims=True)
            mixed[:, offset : offset + track.shape[1]] += track
        return mixed

    def add_to_mix(self, audio: np.ndarray, snr: Optional[Decibels] = None, offset: Seconds = 0.0):
        """
        Add a new track; ``snr`` treats ``audio`` as noise relative to the
        reference (positive SNR ⇒ lower added-signal energy).
        """
        if audio.size == 0:
            return
        assert offset >= 0.0, "Negative offset in mixing is not supported."
        incoming_channels = audio.shape[0]
        if 1 not in (incoming_channels, self.num_channels) and (
            incoming_channels != self.num_channels
        ):
            raise ValueError(
                f"Cannot mix audios with {incoming_channels} and {self.num_channels} channels."
            )
        self.tracks.append(self._snr_gain(audio, snr) * audio)
        self.offsets.append(compute_num_samples(offset, self.sampling_rate))
        self.num_channels = max(self.num_channels, incoming_channels)

    def _snr_gain(self, audio: np.ndarray, snr: Optional[Decibels]) -> float:
        if snr is None or self.reference_energy <= 0:
            return 1.0
        incoming_energy = audio_energy(audio)
        if incoming_energy <= 0.0:
            return 1.0
        target_energy = self.reference_energy * (10.0 ** (-snr / 10))
        # Energy ratio applies to power; gains apply to field quantities.
        return sqrt(target_energy / incoming_energy)
