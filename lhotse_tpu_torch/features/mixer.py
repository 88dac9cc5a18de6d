"""
FeatureMixer: mix feature matrices in the feature domain (copied from
``lhotse_tpu/features/mixer.py``). Pads with a low log-energy value
(default -1000), computes SNR gains from the extractor-defined
``compute_energy`` (power quantities, so the gain is the plain energy
ratio), and combines via the extractor-defined ``mix``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from lhotse_tpu_torch.features.base import FeatureExtractor
from lhotse_tpu_torch.utils import Decibels, Seconds, compute_num_frames


class FeatureMixer:
    """
    Mix multiple feature matrices into one; instantiated per MixedCut with the
    reference features; relies on the FeatureExtractor's ``mix`` /
    ``compute_energy``.
    """

    def __init__(
        self, feature_extractor: FeatureExtractor, base_feats: np.ndarray, frame_shift: Seconds,
        padding_value: float = -1000.0, reference_energy: Optional[float] = None):
        self.feature_extractor = feature_extractor
        self.frame_shift = frame_shift
        self.padding_value = padding_value
        self.tracks = [base_feats]
        self.gains = []
        self.num_channels = 1 if base_feats.ndim == 2 else base_feats.shape[-1]
        self.dtype = base_feats.dtype
        self.reference_energy = (
            feature_extractor.compute_energy(base_feats)
            if reference_energy is None
            else reference_energy
        )

    num_features = property(lambda self: self.tracks[0].shape[1])

    @property
    def unmixed_feats(self) -> np.ndarray:
        """(num_tracks, num_frames, num_features) with per-track padding/scaling."""
        return np.stack(self.tracks)

    @property
    def mixed_feats(self) -> np.ndarray:
        """(num_frames, num_features) mix of all tracks."""
        acc = self.tracks[0]
        for extra, gain in zip(self.tracks[1:], self.gains):
            acc = self.feature_extractor.mix(
                features_a=acc, features_b=extra, energy_scaling_factor_b=gain)
        return acc

    def _filler(self, num_frames: int) -> np.ndarray:
        """Padding block holding the low log-energy constant."""
        shape = [num_frames, self.num_features]
        if self.num_channels != 1:
            shape.append(self.num_channels)
        return np.full(tuple(shape), self.padding_value, dtype=self.dtype)

    def _snr_gain(self, feats: np.ndarray, snr: Optional[Decibels]) -> float:
        if snr is None or self.reference_energy <= 0.0:
            return 1.0
        incoming_energy = self.feature_extractor.compute_energy(feats)
        if incoming_energy <= 0.0:
            return 1.0
        return self.reference_energy * (10.0 ** (-snr / 10)) / incoming_energy

    def add_to_mix(
        self, feats: np.ndarray, sampling_rate: int, snr: Optional[Decibels] = None,
        offset: Seconds = 0.0):
        """Add a feature matrix, padding all tracks to the common mix length."""
        if len(feats) == 0:
            return
        assert offset >= 0.0, "Negative offset in mixing is not supported."
        assert self.tracks[0].ndim == feats.ndim, "Feature dimensions mismatch in mixing"

        lead_frames = compute_num_frames(
            duration=offset, frame_shift=self.frame_shift, sampling_rate=sampling_rate)
        have_frames = self.tracks[0].shape[0]
        new_track_frames = feats.shape[0] + lead_frames
        mix_frames = max(have_frames, new_track_frames)

        # Grow every existing track to the common mix length...
        if have_frames < mix_frames:
            tail = self._filler(mix_frames - have_frames)
            self.tracks = [np.vstack([t, tail]) for t in self.tracks]
        # ...and frame the incoming features with offset/tail padding.
        parts = []
        if lead_frames:
            parts.append(self._filler(lead_frames))
        parts.append(feats)
        if new_track_frames < mix_frames:
            parts.append(self._filler(mix_frames - new_track_frames))
        incoming = np.vstack(parts) if len(parts) > 1 else parts[0]

        self.tracks.append(incoming)
        self.gains.append(self._snr_gain(feats, snr))
