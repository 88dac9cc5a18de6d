"""
Batch signal transforms of the PyTorch port (port of
``lhotse_tpu/dataset/signal_transforms.py``): ``GlobalMVN``,
``SpecAugment``, ``RandomizedSmoothing`` and ``DereverbWPE``, with the
single-matrix helpers ``mask_along_axis_optimized`` and ``time_warp``.

All randomness is drawn on the host from seeded numpy Generators, with the
JAX package's draw code, so the same seed gives bit-identical draws and a
``state_dict`` resumes the stream exactly. The apply steps take a torch
tensor on its own device and dtype, or a numpy array (the collated inputs
of ``K2SpeechRecognitionDataset``), and give back the same kind. SpecAugment's
apply is :func:`lhotse_tpu_torch.ops.augment.apply_specaugment`, one gather
and masked fill over the whole ``(B, T, F)`` batch.
"""
import bisect
import math
from typing import Any, Dict, Optional, Sequence, Tuple, TypeVar, Union

import numpy as np
import torch

from lhotse_tpu_torch.ops.augment import apply_specaugment
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["GlobalMVN", "SpecAugment", "RandomizedSmoothing", "DereverbWPE"]


def _like(x: np.ndarray, features: torch.Tensor) -> torch.Tensor:
    """A host array as a tensor on ``features``' device, in its dtype."""
    return torch.as_tensor(x, device=features.device).to(features.dtype)


class GlobalMVN:
    """Global mean/variance normalization with precomputed float32 statistics."""

    def __init__(self, feature_dim: int):
        self.feature_dim = feature_dim
        self.norm_means = np.zeros(feature_dim, dtype=np.float32)
        self.norm_stds = np.ones(feature_dim, dtype=np.float32)

    @classmethod
    def from_cuts(
        cls, cuts, max_cuts: Optional[int] = None, extractor=None) -> "GlobalMVN":
        stats = cuts.compute_global_feature_stats(max_cuts=max_cuts, extractor=extractor)
        (feature_dim,) = stats["norm_means"].shape
        global_mvn = cls(feature_dim)
        global_mvn.load_state_dict(stats)
        return global_mvn

    @classmethod
    def from_file(cls, stats_file: Pathlike) -> "GlobalMVN":
        with np.load(stats_file) as data:
            stats = {name: data[name] for name in data.files}
        (feature_dim,) = stats["norm_means"].shape
        global_mvn = cls(feature_dim)
        global_mvn.load_state_dict(stats)
        return global_mvn

    def to_file(self, stats_file: Pathlike) -> None:
        np.savez(stats_file, **self.state_dict())

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"norm_means": self.norm_means, "norm_stds": self.norm_stds}

    def load_state_dict(self, state_dict: Dict[str, np.ndarray]) -> None:
        self.norm_means = np.asarray(state_dict["norm_means"], dtype=np.float32)
        self.norm_stds = np.asarray(state_dict["norm_stds"], dtype=np.float32)

    def __call__(self, features, supervision_segments=None):
        if isinstance(features, torch.Tensor):
            return (features - _like(self.norm_means, features)) / _like(self.norm_stds, features)
        return (features - self.norm_means) / self.norm_stds

    forward = __call__

    def inverse(self, features):
        if isinstance(features, torch.Tensor):
            return features * _like(self.norm_stds, features) + _like(self.norm_means, features)
        return features * self.norm_stds + self.norm_means


class RandomizedSmoothing:
    """
    Gaussian noise added to waveforms (randomized smoothing), clipped to
    ``[-1, 1]``. ``sigma`` may be a constant or a step schedule
    ``[(step, value), ...]``. The noise and the per-example mask are drawn
    on the host in float32 (the JAX package's sequence); a tensor gets the
    same noise copied to its device.
    """

    def __init__(
        self, sigma: Union[float, Sequence[Tuple[int, float]]] = 0.1, sample_sigma: bool = True,
        p: float = 0.3, seed: int = 0):
        self.sigma = sigma
        self.sample_sigma = sample_sigma
        self.p = p
        self.step = 0
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def _noise(self, shape: Tuple[int, ...]) -> np.ndarray:
        if isinstance(self.sigma, (float, int)):
            sigma = float(self.sigma)
        else:
            sigma = schedule_value_for_step(self.sigma, self.step)
            self.step += 1

        mask_shape = (shape[0],) + tuple(1 for _ in shape[1:])
        if self.sample_sigma:
            # Stochastic stddev, uniform in [-sigma, sigma] per example.
            sigma = sigma * (2 * self.rng.random(mask_shape) - 1)

        noise = sigma * self.rng.standard_normal(shape).astype(np.float32)
        noise_mask = random_mask_along_batch_axis(
            np.broadcast_to(np.float32(0), shape), p=1.0 - self.p, rng=self.rng)
        return (noise * noise_mask).astype(np.float32)

    def __call__(self, audio, *args, **kwargs):
        if isinstance(audio, torch.Tensor):
            return torch.clamp(audio + _like(self._noise(tuple(audio.shape)), audio), -1.0, 1.0)
        return np.clip(audio + self._noise(np.shape(audio)), -1.0, 1.0)

    forward = __call__

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "seed": self.seed, "rng_state": self.rng.bit_generator.state}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.step = state_dict.get("step", self.step)
        self.seed = state_dict.get("seed", self.seed)
        if "rng_state" in state_dict:
            self.rng.bit_generator.state = state_dict["rng_state"]


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

    def _axis_mask_single(
        self, dim: int, mask_size: int, mask_times: int, rng=None
    ) -> np.ndarray:
        """Boolean (dim,) union of ``mask_times`` random spans."""
        return self._axis_masks_batch(1, dim, mask_size, mask_times, rng=rng)[0]

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

    def __call__(self, features, supervision_segments=None, *args, **kwargs):
        """
        :param features: ``(B, T, F)`` feature tensor, or numpy array.
        :param supervision_segments: optional int array ``(S, 3)`` of
            (sequence_idx, start_frame, num_frames); when given, time warping
            is restricted to the supervised spans while masking still covers
            the full matrices.
        :return: the augmented batch, same shape, dtype and device (a numpy
            array for a numpy array, computed on the CPU).
        """
        assert features.ndim == 3, (
            "SpecAugment only supports batches of single-channel feature matrices."
        )
        host = isinstance(features, np.ndarray)
        x = torch.from_numpy(features) if host else features
        b, t, f = x.shape
        warp_src, time_mask, freq_mask = self.draw_batch(
            b, t, f, supervision_segments=supervision_segments
        )
        device = x.device
        out = apply_specaugment(
            x, torch.as_tensor(warp_src, dtype=torch.float32, device=device),
            torch.as_tensor(time_mask, device=device), torch.as_tensor(freq_mask, device=device))
        return out.numpy() if host else out

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

    def state_dict(self) -> Dict[str, Any]:
        """The settings and the generator's state. It takes no ``after=``
        (the JAX package's accepts and ignores one), so a prefetching
        ``DataLoader`` saves the state its producer snapshotted right after
        the yielded batch, not the live one its producer has run ahead with."""
        return dict(
            time_warp_factor=self.time_warp_factor, num_feature_masks=self.num_feature_masks,
            features_mask_size=self.features_mask_size, num_frame_masks=self.num_frame_masks,
            frames_mask_size=self.frames_mask_size,
            max_frames_mask_fraction=self.max_frames_mask_fraction, p=self.p,
            rng_state=self.rng.bit_generator.state)

    def load_state_dict(self, state_dict: Dict[str, Any]):
        self.time_warp_factor = state_dict.get("time_warp_factor", self.time_warp_factor)
        self.num_feature_masks = state_dict.get("num_feature_masks", self.num_feature_masks)
        self.features_mask_size = state_dict.get("features_mask_size", self.features_mask_size)
        self.num_frame_masks = state_dict.get("num_frame_masks", self.num_frame_masks)
        self.frames_mask_size = state_dict.get("frames_mask_size", self.frames_mask_size)
        self.max_frames_mask_fraction = state_dict.get(
            "max_frames_mask_fraction", self.max_frames_mask_fraction)
        self.p = state_dict.get("p", self.p)
        if "rng_state" in state_dict:
            self.rng.bit_generator.state = state_dict["rng_state"]


def mask_along_axis_optimized(
    features: np.ndarray, mask_size: int, mask_times: int, mask_value: float, axis: int,
    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """
    Mask ``mask_times`` random spans of width < ``mask_size`` along ``axis``
    of a ``(T, F)`` matrix (1 = time, 2 = frequency).
    """
    if axis not in (1, 2):
        raise ValueError("Only Frequency and Time masking are supported!")
    if rng is None:
        rng = np.random.default_rng()
    features = np.array(features, copy=True)
    dim = features.shape[0] if axis == 1 else features.shape[1]
    widths = rng.integers(0, int(mask_size), size=mask_times)
    starts = (rng.random(mask_times) * (dim - widths)).astype(np.int64)
    for s, w in zip(starts, widths):
        if axis == 1:
            features[s : s + w, :] = mask_value
        else:
            features[:, s : s + w] = mask_value
    return features


def time_warp(
    features: np.ndarray, factor: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """
    SpecAugment time warping of a single ``(T, F)`` matrix via
    piecewise-linear resampling around a random center.
    """
    if rng is None:
        rng = np.random.default_rng()
    t = features.shape[0]
    if t - factor <= factor + 1:
        return features
    center = int(rng.integers(factor + 1, t - factor))
    warped = int(rng.integers(center - factor, center + factor + 1))
    if warped == center:
        return features
    src = np.empty(t, dtype=np.float64)
    src[:warped] = np.arange(warped) * (center / warped)
    src[warped:] = center + np.arange(t - warped) * ((t - center) / (t - warped))
    lo = np.clip(np.floor(src).astype(np.int64), 0, t - 1)
    hi = np.clip(lo + 1, 0, t - 1)
    frac = (src - lo)[:, None]
    return ((1.0 - frac) * features[lo] + frac * features[hi]).astype(features.dtype)


T = TypeVar("T")


def schedule_value_for_step(schedule: Sequence[Tuple[int, T]], step: int) -> T:
    milestones, values = zip(*schedule)
    assert milestones[0] <= step, (
        f"Cannot determine the scheduled value for step {step} with schedule: "
        f"{schedule}. Did you forget to add the first part of the schedule "
        f"for steps below {milestones[0]}?"
    )
    idx = bisect.bisect_right(milestones, step) - 1
    return values[idx]


def random_mask_along_batch_axis(
    tensor: np.ndarray, p: float = 0.5, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """
    Mask of shape ``(N, 1, 1, ...)`` that zeroes each batch element with
    probability ``p``.
    """
    if rng is None:
        rng = np.random.default_rng()
    mask_shape = (tensor.shape[0],) + tuple(1 for _ in tensor.shape[1:])
    return (rng.random(mask_shape) > p).astype(np.float32)


class DereverbWPE:
    """
    Weighted Prediction Error dereverberation over batches: the port's host
    WPE (:func:`lhotse_tpu_torch.augmentation.wpe.dereverb_wpe_numpy`, the
    algorithm of the nara_wpe package) on each item. A tensor comes back on
    its device, in its dtype.
    """

    def __init__(self, n_fft: int = 512, hop_length: int = 128):
        self.n_fft = n_fft
        self.hop_length = hop_length

    def __call__(self, audio, *args, **kwargs):
        """
        ``(B, T)`` single-channel or ``(B, D, T)`` multi-channel batches.
        """
        from lhotse_tpu_torch.augmentation.wpe import dereverb_wpe_numpy

        if isinstance(audio, torch.Tensor):
            return _like(self(audio.detach().cpu().numpy()), audio)
        audio = np.asarray(audio)
        if audio.ndim == 2:
            return np.concatenate(
                [dereverb_wpe_numpy(a[None, :], n_fft=self.n_fft, hop_length=self.hop_length)
                 for a in audio],
                axis=0)
        assert audio.ndim == 3
        return np.stack(
            [dereverb_wpe_numpy(a, n_fft=self.n_fft, hop_length=self.hop_length) for a in audio],
            axis=0)

    forward = __call__
