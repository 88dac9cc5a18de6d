"""
SpecAugment for the PyTorch port (port of the ``SpecAugment`` class of
``lhotse_tpu/dataset/signal_transforms.py``).

The randomness is drawn on the host from a seeded numpy Generator and
compiled into per-example fractional warp maps and boolean time/frequency
masks; the draw code is a copy of the JAX package's, so the same seed gives
bit-identical draws. The apply step is
:func:`lhotse_tpu_torch.ops.augment.apply_specaugment`, one gather and
masked fill over the whole ``(B, T, F)`` tensor on its device.
"""
import math
from typing import Optional, Tuple

import numpy as np
import torch

from lhotse_tpu_torch.ops.augment import apply_specaugment

__all__ = ["SpecAugment"]


class SpecAugment:
    """
    SpecAugment (time warp + frequency masks + time masks) applied to a
    batch of feature matrices ``(B, T, F)``.

    Randomness is drawn host-side per example from a seeded Generator and
    compiled into (a) a per-example fractional source-index map implementing
    the piecewise-linear time warp and (b) boolean time/frequency masks; the
    apply step is a single vectorized linear-interp gather + masked fill
    across the batch.
    """

    def __init__(
        self, time_warp_factor: Optional[int] = 80, num_feature_masks: int = 2,
        features_mask_size: int = 27, num_frame_masks: int = 10, frames_mask_size: int = 100,
        max_frames_mask_fraction: float = 0.15, p=0.9, seed: int = 0):
        """
        :param time_warp_factor: warp strength ``W``; None or <1 disables.
        :param num_feature_masks: number of frequency masks (0 disables).
        :param features_mask_size: max width of each frequency mask (``F``).
        :param num_frame_masks: number of time masks (0 disables).
        :param frames_mask_size: max width of each time mask (``T``).
        :param max_frames_mask_fraction: cap on total masked frames as a
            fraction of the utterance length (``p`` in the paper).
        :param p: probability of applying the transform per example
            (NOT the paper's ``p``).
        """
        assert 0 <= p <= 1
        assert num_feature_masks >= 0
        assert num_frame_masks >= 0
        assert features_mask_size > 0
        assert frames_mask_size > 0
        self.time_warp_factor = time_warp_factor
        self.num_feature_masks = num_feature_masks
        self.features_mask_size = features_mask_size
        self.num_frame_masks = num_frame_masks
        self.frames_mask_size = frames_mask_size
        self.max_frames_mask_fraction = max_frames_mask_fraction
        self.p = p
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    # --- host-side randomness → index maps and masks ---------------------

    def _warp_map_single(self, t: int, rng=None) -> np.ndarray:
        """Fractional source indices (t,) for one example's time warp."""
        rng = self.rng if rng is None else rng
        factor = self.time_warp_factor
        idx = np.arange(t, dtype=np.float64)
        if factor is None or factor < 1 or t - factor <= factor + 1:
            return idx
        center = rng.integers(factor + 1, t - factor)
        warped = rng.integers(center - factor, center + factor + 1)
        if warped == center:
            return idx
        src = np.empty(t, dtype=np.float64)
        # [0, warped) maps linearly onto [0, center); the rest onto [center, t).
        left = np.arange(warped, dtype=np.float64)
        src[:warped] = left * (center / warped)
        right = np.arange(t - warped, dtype=np.float64)
        src[warped:] = center + right * ((t - center) / (t - warped))
        return src

    def _axis_masks_batch(
        self, n: int, dim: int, mask_size: int, mask_times: int, rng=None
    ) -> np.ndarray:
        """Boolean (n, dim): per row, the union of ``mask_times`` random
        spans — one vectorized draw for the whole batch."""
        rng = self.rng if rng is None else rng
        if n <= 0 or mask_times <= 0 or mask_size <= 0:
            return np.zeros((max(n, 0), dim), dtype=bool)
        widths = rng.integers(0, int(mask_size), size=(n, mask_times))
        starts = (rng.random((n, mask_times)) * (dim - widths)).astype(np.int64)
        idx = np.arange(dim)
        return (
            (idx >= starts[:, :, None]) & (idx < (starts + widths)[:, :, None])
        ).any(axis=1)

    def _time_mask_params(self, t: int) -> Tuple[int, int]:
        max_tot_mask_frames = self.max_frames_mask_fraction * t
        num_frame_masks = min(
            self.num_frame_masks, math.ceil(max_tot_mask_frames / self.frames_mask_size))
        if num_frame_masks <= 0:
            return 0, 0
        max_mask_frames = int(min(self.frames_mask_size, max_tot_mask_frames // num_frame_masks))
        return num_frame_masks, max_mask_frames

    def __call__(self, features: torch.Tensor, supervision_segments=None) -> torch.Tensor:
        """
        :param features: ``(B, T, F)`` feature tensor.
        :param supervision_segments: optional int array ``(S, 3)`` of
            (sequence_idx, start_frame, num_frames); when given, time warping
            is restricted to the supervised spans while masking still covers
            the full matrices.
        :return: the augmented tensor, same shape, dtype and device.
        """
        assert features.ndim == 3, (
            "SpecAugment only supports batches of single-channel feature matrices."
        )
        b, t, f = features.shape
        warp_src, time_mask, freq_mask = self.draw_batch(
            b, t, f, supervision_segments=supervision_segments
        )
        device = features.device
        return apply_specaugment(
            features, torch.as_tensor(warp_src, dtype=torch.float32, device=device),
            torch.as_tensor(time_mask, device=device), torch.as_tensor(freq_mask, device=device))

    forward = __call__

    def draw_batch(self, b: int, t: int, f: int, supervision_segments=None, rng=None):
        """
        Draw one batch worth of SpecAugment randomness WITHOUT applying it:
        ``(warp_src (B, T) float64 fractional source indices, time_mask
        (B, T) bool, freq_mask (B, F) bool)``. Semantics and RNG stream are
        identical to calling the transform directly on a ``(B, T, F)`` batch.

        ``rng`` overrides the transform's own sequential stream with an
        externally-derived generator — OnDeviceAugmenter passes a per-batch
        counter-keyed generator so that checkpoints taken between yielded
        batches stay consistent even while a prefetch thread stages ahead.
        """
        rng = self.rng if rng is None else rng
        # Per-example warp maps (identity rows when not applied).
        warp_src = np.tile(np.arange(t, dtype=np.float64), (b, 1))
        apply_flags = rng.random(b) <= self.p

        if supervision_segments is None:
            factor = self.time_warp_factor
            apply_idx = np.flatnonzero(apply_flags)
            if (
                factor is not None
                and factor >= 1
                and t - factor > factor + 1
                and len(apply_idx)
            ):
                k = len(apply_idx)
                centers = rng.integers(factor + 1, t - factor, size=k)
                warped = centers - factor + rng.integers(
                    0, 2 * factor + 1, size=k
                )
                sel = warped != centers  # warped == center is the identity map
                if np.any(sel):
                    rows = apply_idx[sel]
                    c = centers[sel].astype(np.float64)
                    w = warped[sel].astype(np.float64)
                    idx = np.arange(t, dtype=np.float64)
                    # [0, warped) maps linearly onto [0, center); the rest
                    # onto [center, t) — same map as _warp_map_single.
                    left = idx[None, :] * (c / w)[:, None]
                    right = (
                        c[:, None]
                        + (idx[None, :] - w[:, None])
                        * ((t - c) / (t - w))[:, None]
                    )
                    warp_src[rows] = np.where(idx[None, :] < w[:, None], left, right)
        else:
            segs = np.asarray(supervision_segments)
            for sequence_idx, start_frame, num_frames in segs:
                sequence_idx, start_frame, num_frames = (
                    int(sequence_idx), int(start_frame), int(num_frames))
                # Each segment independently samples its apply decision.
                if rng.random() > self.p:
                    continue
                seg_map = self._warp_map_single(num_frames, rng=rng)
                warp_src[sequence_idx, start_frame : start_frame + num_frames] = (
                    start_frame + seg_map
                )

        # Per-example masks. In supervision mode, masking decisions are
        # independent of warping decisions.
        if supervision_segments is None:
            mask_flags = apply_flags
        else:
            mask_flags = rng.random(b) <= self.p
        freq_mask = np.zeros((b, f), dtype=bool)
        time_mask = np.zeros((b, t), dtype=bool)
        num_frame_masks, max_mask_frames = self._time_mask_params(t)
        n_apply = int(np.count_nonzero(mask_flags))
        if n_apply:
            # One vectorized draw per axis for all applied examples.
            freq_mask[mask_flags] = self._axis_masks_batch(
                n_apply, f, self.features_mask_size, self.num_feature_masks,
                rng=rng)
            time_mask[mask_flags] = self._axis_masks_batch(
                n_apply, t, max_mask_frames, num_frame_masks, rng=rng)

        return warp_src, time_mask, freq_mask
