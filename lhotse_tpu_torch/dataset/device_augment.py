"""
Bucket-shaped device augment→fbank stage for PyTorch training input
pipelines (port of ``lhotse_tpu/dataset/device_augment.py``).

The host pipeline decodes and collates raw audio; the device runs the whole
chain per bucket shape:

    wire decode → speed perturb → volume gain → SNR noise mix → RIR reverb
    → fbank [→ SpecAugment warp + masks]

The per-batch randomness is drawn on the host from a generator keyed by
``(seed, specaugment.seed, stage counter)``, exactly as in the JAX package,
so the two augmenters draw bit-identical gains, SNRs, mix masks and
SpecAugment maps for the same seed and counter, and a JAX augmenter's
``state_dict()`` resumes the same stream here.

Typical use::

    aug = OnDeviceAugmenter(
        buckets=[(6.0, 40), (9.0, 27), (12.0, 20)],
        speed_factor=1.1,
        noise_pool=musan_samples,      # (N, T) float32 host array
        rir=rir_taps,                  # (L,) float32
        snr=(10, 20),
        mix_prob=0.5,
        device="cuda",
    )
    for batch in loader:               # dataset = AudioSamples strategy
        feats, feat_lens = aug(batch["inputs"], batch["input_lens"])
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lhotse_tpu_torch.ops.augment import make_augment_fbank_pipeline, resolve_fbank_layer
from lhotse_tpu_torch.ops.resample import resampled_num_samples
from lhotse_tpu_torch.ops.wire import encode_wire, wire_np_dtype, wire_row_width


def _to_device(x, device: torch.device):
    """A host array (or tensor) on ``device``. A host array bound for a CUDA
    device is copied through pinned memory without blocking the host; the
    copy is ordered on the current stream before any kernel that reads it."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclass
class StagedBatch:
    """A batch already padded/encoded and (asynchronously) transferred to the
    device, awaiting :meth:`OnDeviceAugmenter.compute`."""

    audio: Any  # device tensor, bucket shape (B_b, T_b), wire dtype (numpy if transfer=False)
    lens: np.ndarray  # (B_b,) valid sample counts (0 = padding row)
    kwargs: Dict[str, Any] = field(default_factory=dict)
    # Sample-cache bookkeeping (miss path): write these rows into the
    # bucket pool at compute time — zero extra wire bytes.
    bucket_t: Optional[int] = None
    insert_slots: Optional[np.ndarray] = None
    # Staging counter this batch's augmentation randomness was keyed by —
    # pass to OnDeviceAugmenter.state_dict(after=...) for checkpoints that
    # stay consistent while a prefetch thread stages ahead.
    aug_counter: Optional[int] = None


@dataclass
class CachedBatch:
    """A batch whose audio is already resident in the device sample cache —
    :meth:`OnDeviceAugmenter.compute` gathers pool rows by slot; nothing
    crosses the wire."""

    bucket_t: int
    slots: np.ndarray  # (B_b,) int32 pool rows (scratch slot = padding)
    lens: np.ndarray  # (B_b,) valid sample counts (0 = padding row)
    kwargs: Dict[str, Any] = field(default_factory=dict)
    aug_counter: Optional[int] = None  # see StagedBatch.aug_counter


class OnDeviceAugmenter:
    """
    Bucket-shaped device augment→fbank stage.

    :param buckets: shape vocabulary as (max_seconds, batch_size) pairs,
        ascending by duration; every incoming batch is padded up to the
        smallest covering bucket.
    :param sampling_rate: audio sampling rate.
    :param speed_factor: optional sox-speed factor applied on device.
    :param gain_range: per-item volume perturbation range (uniform), or
        None to disable.
    :param noise_pool: optional (N, T_noise) float32 host array of noise
        clips; a slice per bucket shape is staged on the device once.
    :param snr: (low, high) SNR dB range for noise mixing.
    :param mix_prob: probability of mixing noise into each item.
    :param rir: optional (L,) float32 impulse response (shared; kept on the
        host side of the pipeline so its peak is found once).
    :param wire_format: host->device transfer encoding — "float32"
        (lossless), "int16" (half the bytes), "mulaw" (8-bit, lossy) or
        "adpcm4" (4-bit block ADPCM, lossy, ~1/7 the bytes; bucket shapes
        must be multiples of 64 samples); see :mod:`lhotse_tpu_torch.ops.wire`.
    :param seed: host RNG seed for gains/SNRs/noise choice.
    :param sample_cache: optional
        :class:`~lhotse_tpu_torch.dataset.device_cache.DeviceSampleCache`
        keeping wire-format audio resident on ``device`` across epochs —
        fully-resident batches skip the host→device transfer. Pass the
        batch's cut ids to :meth:`stage`.
    :param specaugment: optional
        :class:`~lhotse_tpu_torch.dataset.signal_transforms.SpecAugment`;
        its randomness is drawn host-side per batch over the bucket's frame
        grid and the apply step runs on the device after the fbank.
    :param device: the device the batches are computed on.
    """

    def __init__(
        self,
        buckets: Sequence[Tuple[float, int]],
        sampling_rate: int = 16000,
        speed_factor: Optional[float] = None,
        gain_range: Optional[Tuple[float, float]] = (0.9, 1.1),
        noise_pool: Optional[np.ndarray] = None,
        snr: Tuple[float, float] = (10.0, 20.0),
        mix_prob: float = 0.5,
        rir: Optional[np.ndarray] = None,
        normalize_rir: bool = True,
        fbank=None,
        wire_format: str = "float32",
        seed: int = 0,
        sample_cache=None,
        specaugment=None,
        *,
        device,
    ) -> None:
        assert len(buckets) > 0
        for ub, _ in buckets:
            # Raises ValueError for an unknown format, and for adpcm4 on a
            # bucket that is not a whole number of blocks.
            wire_row_width(int(float(ub) * sampling_rate), wire_format)
        self.device = torch.device(device)
        self.buckets = sorted((float(s), int(b)) for s, b in buckets)
        self.sampling_rate = int(sampling_rate)
        self.speed_factor = speed_factor
        self.gain_range = gain_range
        self.snr = snr
        self.mix_prob = float(mix_prob)
        self.rir = None if rir is None else np.asarray(rir, np.float32)
        self.wire_format = wire_format
        self._seed = int(seed)
        # Per-batch randomness is KEYED by (seed, specaugment seed, stage
        # counter) rather than drawn from one sequential stream, so that a
        # checkpoint is just the next counter value even while a prefetch
        # thread stages batches ahead (see state_dict(after=...)).
        self._stage_counter = 0
        self.specaugment = specaugment
        fbank = resolve_fbank_layer(fbank, self.sampling_rate, self.device)
        self._feat_hop = round(fbank.frame_shift * self.sampling_rate)
        self._num_mels = int(getattr(fbank, "num_filters", 80))
        self._pipeline = make_augment_fbank_pipeline(
            sampling_rate=self.sampling_rate,
            speed_factor=speed_factor,
            normalize_rir=normalize_rir,
            fbank=fbank,
            wire_format=wire_format,
            rir=self.rir,
            device=self.device,
        )
        self._noise_host = (
            None if noise_pool is None else np.asarray(noise_pool, np.float32)
        )
        self._noise_device: dict = {}
        self.sample_cache = sample_cache
        if sample_cache is not None:
            sample_cache.configure([ub for ub, _ in self.buckets], self.device)

    # -- shapes -----------------------------------------------------------------

    def bucket_shape(self, num_samples: int) -> Tuple[int, int]:
        """(padded_num_samples, batch_size) of the smallest covering bucket
        (the largest bucket when nothing covers)."""
        for ub, bsz in self.buckets:
            if num_samples <= int(ub * self.sampling_rate):
                return int(ub * self.sampling_rate), bsz
        ub, bsz = self.buckets[-1]
        return int(ub * self.sampling_rate), bsz

    def _post_perturb_len(self, t: int) -> int:
        if self.speed_factor is None or self.speed_factor == 1.0:
            return t
        return resampled_num_samples(
            t, round(self.sampling_rate * self.speed_factor), self.sampling_rate
        )

    def _noise_for(self, batch_size: int, t_perturbed: int) -> torch.Tensor:
        """A (B, T') noise batch on the device, one per bucket shape. The
        slice assignment is drawn once per shape from a shape-keyed RNG (not
        the per-batch stream, so bucket-arrival order changes no later draw)
        and reused across batches; per-batch SNR/gain/mask still vary."""
        key = (batch_size, t_perturbed)
        staged = self._noise_device.get(key)
        if staged is None:
            pool = self._noise_host
            n, tn = pool.shape
            shape_rng = np.random.RandomState(
                np.array(
                    [self._seed & 0x7FFFFFFF, batch_size, t_perturbed],
                    dtype=np.uint32,
                )
            )
            rows = shape_rng.randint(0, n, size=batch_size)
            if tn >= t_perturbed:
                starts = shape_rng.randint(0, tn - t_perturbed + 1, size=batch_size)
                sel = np.stack(
                    [pool[r, s : s + t_perturbed] for r, s in zip(rows, starts)]
                )
            else:
                reps = -(-t_perturbed // tn)
                sel = np.tile(pool[rows], (1, reps))[:, :t_perturbed]
            staged = _to_device(sel, self.device)
            self._noise_device[key] = staged
        return staged

    # -- execution --------------------------------------------------------------

    def precompile(self, group: int = 1) -> None:
        """Run every bucket once outside the hot loop: builds the fbank
        kernel at first use, plans the FFTs and convolutions, and stages the
        per-bucket noise. With a sample cache attached, the cached gather
        path runs per bucket too (the warmup rows land in ring slots and are
        evicted naturally). ``group`` is accepted for the JAX package's
        signature: :meth:`compute_grouped` runs batch by batch here, so it
        has no shape of its own to warm.

        RNG-neutral: the warmup draws (and discards) per-batch augmentation
        randomness, so the stream state is snapshotted and restored."""
        rng_snapshot = self.state_dict()
        for bi, (ub, bsz) in enumerate(self.buckets):
            t = int(ub * self.sampling_rate)
            zeros = np.zeros((bsz, t), np.float32)
            lens = np.full(bsz, t, np.int64)
            if self.sample_cache is None:
                self(zeros, lens)
            else:
                ids = [f"__precompile_{bi}_{k}__" for k in range(bsz)]
                self.compute(self.stage(zeros, lens, ids=ids))  # miss+insert
                self.compute(self.stage(zeros, lens, ids=ids))  # cached path
        self.load_state_dict(rng_snapshot)

    def compute_grouped(self, staged_batches):
        """Run ``k`` staged batches of the SAME bucket, returning per-batch
        ``(feats, feat_lens)``. Takes either all-:class:`CachedBatch` or
        all-:class:`StagedBatch`; cache-miss batches go through
        :meth:`compute`, as in the JAX package.

        The JAX package runs the group as one ``k*B`` mega-batch and is
        bit-identical to per-batch compute. Here each batch runs on its own:
        torch's row reductions (the SNR and reverb energies) round
        differently in a ``k*B`` batch, which moved near-silent log-mel bins
        by up to 1.6e-4, past the feature budget. So the result is exactly
        :meth:`compute`'s."""
        assert staged_batches, "compute_grouped needs at least one batch"
        assert (all(isinstance(s, StagedBatch) for s in staged_batches)
                or all(isinstance(s, CachedBatch) for s in staged_batches)), (
            "compute_grouped needs all-cached or all-transfer batches")
        assert all(s.bucket_t == staged_batches[0].bucket_t for s in staged_batches), (
            "grouped batches must share one bucket shape")
        assert all(getattr(s, "insert_slots", None) is None for s in staged_batches), (
            "cache-miss batches carry pool writes; dispatch them individually through compute()")
        return [self.compute(s) for s in staged_batches]

    def batch_rng(self, counter: int) -> np.random.Generator:
        """The keyed per-batch generator: all of batch ``counter``'s host
        randomness (gains / SNR / mix mask / SpecAugment warp+masks) derives
        from ``(seed, specaugment.seed, counter)`` — independent of how many
        batches a prefetch thread has staged ahead."""
        sa_seed = getattr(self.specaugment, "seed", None)
        return np.random.default_rng(
            (self._seed, 0 if sa_seed is None else int(sa_seed), int(counter))
        )

    def state_dict(self, after=None) -> dict:
        """Checkpoint the augmentation randomness: the next staging counter.

        :param after: optional staged batch (the LAST one the training loop
            consumed), or a tuple/list of them. With a prefetch thread, the
            augmenter's live counter runs ahead of consumption; passing the
            consumed batch pins the checkpoint to it exactly.
        """
        if after is None:
            counter = self._stage_counter
        else:
            counter = self._counter_after(after)
        return {"seed": self._seed, "next_counter": counter}

    def _counter_after(self, after) -> int:
        """Next staging counter implied by a consumed batch: its
        ``aug_counter`` + 1. Accepts a staged batch, or a tuple/list of
        them (grouped dispatch) — the max counter wins."""
        if isinstance(after, (tuple, list)):
            counters = [
                c
                for c in (getattr(el, "aug_counter", None) for el in after)
                if c is not None
            ]
            if not counters:
                raise ValueError(
                    "state_dict(after=...) needs batches staged by this "
                    "augmenter (none of the elements carries aug_counter)."
                )
            return max(int(c) for c in counters) + 1
        c = getattr(after, "aug_counter", None)
        if c is None:
            raise ValueError(
                "state_dict(after=...) needs a batch staged by this "
                "augmenter (no aug_counter on the given object)."
            )
        return int(c) + 1

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore a checkpoint of this augmenter or of the JAX package's
        ``OnDeviceAugmenter`` (the same ``{"seed", "next_counter"}`` dict)."""
        if "rng_state" in state_dict:
            raise ValueError(
                "This checkpoint was written by an older OnDeviceAugmenter "
                "whose randomness was a sequential RNG stream; it cannot be "
                "restored into the counter-keyed design (which exists to "
                "keep checkpoints consistent under prefetch)."
            )
        if int(state_dict["seed"]) != self._seed:
            raise ValueError(
                f"Augmenter checkpoint was written with seed "
                f"{state_dict['seed']}, but this augmenter uses seed "
                f"{self._seed} — restoring would change the stream."
            )
        self._stage_counter = int(state_dict["next_counter"])

    def _draw_kwargs(self, B_b: int, T_b: int) -> dict:
        """Per-batch augmentation draws (keyed host RNG, numpy) + the shared
        device noise. Consumes one staging-counter value per call."""
        counter = self._stage_counter
        self._stage_counter = counter + 1
        rng = self.batch_rng(counter)
        kwargs = {}
        if self.gain_range is not None:
            lo, hi = self.gain_range
            kwargs["gains"] = rng.uniform(lo, hi, B_b).astype(np.float32)
        if self._noise_host is not None:
            t_p = self._post_perturb_len(T_b)
            kwargs["noise"] = self._noise_for(B_b, t_p)
            lo, hi = self.snr
            kwargs["snr"] = rng.uniform(lo, hi, B_b).astype(np.float32)
            kwargs["mix_mask"] = (
                rng.uniform(0, 1, B_b) < self.mix_prob
            ).astype(np.float32)
        if self.specaugment is not None:
            # Host-side randomness over the bucket's (post-perturb) frame
            # grid; the pipeline slices these down to the fbank's actual
            # frame count.
            n_frames = (
                self._post_perturb_len(T_b) + self._feat_hop // 2
            ) // self._feat_hop
            warp_src, time_mask, freq_mask = self.specaugment.draw_batch(
                B_b, int(n_frames), self._num_mels, rng=rng
            )
            kwargs["warp_src"] = warp_src.astype(np.float32)
            kwargs["time_mask"] = time_mask
            kwargs["freq_mask"] = freq_mask
        return kwargs

    def stage(
        self,
        audio: np.ndarray,
        audio_lens: Union[np.ndarray, Sequence[int]],
        ids: Optional[Sequence[str]] = None,
        transfer: bool = True,
    ) -> Union[StagedBatch, CachedBatch]:
        """
        Host-side half of :meth:`__call__`: pad ``(B, T)`` float32 (or int16)
        audio up to its bucket shape, encode the wire format, draw the
        per-batch augmentation randomness, and copy the speech batch and the
        draws to the device through pinned memory without blocking.

        Call this from a prefetch thread so the host→device transfer of batch
        N+1 overlaps the device compute of batch N, then hand the result to
        :meth:`compute`. ``transfer=False`` leaves the wire bytes and draws
        on the host (numpy) for a downstream transfer stage
        (:func:`lhotse_tpu_torch.dataset.loader.transfer_stream`).

        With a :class:`~lhotse_tpu_torch.dataset.device_cache.DeviceSampleCache`
        attached and ``ids`` given, a fully-resident batch returns a
        :class:`CachedBatch` (slot indices only, no audio transfer; ``audio``
        may then be a ``(B, 0)`` placeholder), and a miss batch is
        transferred once and written into the pool by :meth:`compute`.
        """
        audio = np.asarray(audio)
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        audio_lens = np.asarray(audio_lens)
        B = audio.shape[0]
        T = audio.shape[1] if audio.shape[1] else int(audio_lens.max())
        T_b, B_b = self.bucket_shape(T)
        if B > B_b:
            raise ValueError(
                f"Batch of {B} items exceeds the covering bucket's batch size "
                f"{B_b} (bucket {T_b / self.sampling_rate:g}s). Silently "
                "dropping items would lose data — align the sampler's "
                "max_cuts/max_duration with the bucket vocabulary, or enlarge "
                "the bucket batch sizes."
            )
        lens = np.zeros(B_b, np.int64)
        lens[:B] = np.minimum(audio_lens, T_b)
        counter = self._stage_counter  # the value _draw_kwargs consumes
        kwargs = self._draw_kwargs(B_b, T_b)

        cache = self.sample_cache
        if cache is not None and ids is not None and cache.has_all(ids, T_b):
            if transfer:
                kwargs = {k: _to_device(v, self.device) for k, v in kwargs.items()}
            return CachedBatch(
                T_b, cache.slots(ids, T_b, B_b), lens, kwargs, aug_counter=counter)

        if audio.shape[1] == 0:
            raise ValueError(
                "Got a zero-width audio placeholder for a batch that is not "
                "fully cache-resident — pass the real samples (is the "
                "sampler's duration_bins vocabulary aligned with the "
                "augmenter buckets?)"
            )
        # np.empty + explicit pad fills: zeroing the full (B_b, T_b) canvas
        # before overwriting most of it costs real time per batch.
        n = min(T, T_b)
        padded = np.empty((B_b, T_b), np.float32)
        padded[:B, :n] = audio[:, :T_b]
        if n < T_b:
            padded[:B, n:] = 0.0
        if B < B_b:
            padded[B:] = 0.0
        padded = encode_wire(padded, self.wire_format)
        if transfer:
            padded = _to_device(padded, self.device)
            kwargs = {k: _to_device(v, self.device) for k, v in kwargs.items()}
        staged = StagedBatch(padded, lens, kwargs, bucket_t=T_b, aug_counter=counter)
        if cache is not None and ids is not None:
            staged.insert_slots = cache.reserve(ids, T_b, B_b, self.sampling_rate)
        return staged

    def compute(self, staged: Union[StagedBatch, CachedBatch]):
        """Device-side half: run the bucket pipeline on a staged batch (a
        :class:`CachedBatch` gathers its wire rows from the pool; a miss
        batch writes its wire rows into the pool first). Returns device
        tensors ``(feats (B', T_frames, F), feat_lens (B',))`` where ``B'``
        is the bucket batch size (padding rows have ``feat_lens == 0``)."""
        if isinstance(staged, CachedBatch):
            pool = self.sample_cache.pool(
                staged.bucket_t, wire_np_dtype(self.wire_format),
                row_width=wire_row_width(staged.bucket_t, self.wire_format))
            slots = _to_device(staged.slots.astype(np.int64), self.device)
            return self._pipeline(pool[slots], staged.lens, **staged.kwargs)
        audio = staged.audio
        if staged.insert_slots is not None:
            audio = _to_device(audio, self.device)
            self.sample_cache.insert(staged.bucket_t, audio, staged.insert_slots)
        return self._pipeline(audio, staged.lens, **staged.kwargs)

    def __call__(
        self,
        audio: np.ndarray,
        audio_lens: Union[np.ndarray, Sequence[int]],
    ):
        """
        Pad ``(B, T)`` float32 (or int16) audio up to its bucket shape and
        run the pipeline (``compute(stage(...))``). Returns device tensors
        ``(feats (B', T_frames, F), feat_lens (B',))``.
        """
        return self.compute(self.stage(audio, audio_lens))
