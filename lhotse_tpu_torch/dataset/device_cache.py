"""
Device-resident sample cache (port of ``lhotse_tpu/dataset/device_cache.py``):
keep the wire-encoded training audio in device memory across epochs, so
steady-state training needs neither host decode nor host→device transfer.

Design, as in the JAX package:

- One pool per bucket shape, a tensor of ``(n_slots + 1, row_width)`` in the
  augmenter's wire dtype on the augmenter's device (the +1 row is scratch for
  padding writes). For adpcm4 the rows are the narrow wire rows, not ``T_b``
  samples.
- Batches are staged all-or-nothing: if every cut of a batch is resident in
  its bucket's pool, :meth:`OnDeviceAugmenter.stage` returns a slot-indexed
  :class:`~lhotse_tpu_torch.dataset.device_augment.CachedBatch` (nothing is
  transferred); otherwise the batch crosses the wire as usual and its rows,
  already on the device, are written into the pool in place.
- Eviction is a per-bucket ring: reserving a slot drops its previous
  occupant from the index, so an over-capacity corpus degrades to partial
  caching, never to wrong data.

The JAX package's ``CacheAwareAudioSamples`` input strategy subclasses its
host data layer, which this package does not import; it is not ported.

Typical use::

    cache = DeviceSampleCache(capacity_seconds=4 * 3600)
    aug = OnDeviceAugmenter(BUCKETS, ..., sample_cache=cache, device="cuda")
    for batch in batches:              # epoch 1 fills, epoch 2+ hits
        ids, lens = batch_cut_info(batch)
        feats, feat_lens = aug.compute(aug.stage(batch["inputs"], lens, ids=ids))
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _canonical(device) -> torch.device:
    """``device`` with the current CUDA index filled in, so that "cuda" and
    "cuda:0" name one device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


class DeviceSampleCache:
    """
    Device pools of wire-format audio rows, keyed by (bucket shape, cut id).

    :param capacity_seconds: total audio the cache may hold across buckets;
        each bucket's slot count is ``capacity_seconds / num_buckets / ub``
        (allocated lazily on first use, only for buckets actually seen).
    :param min_slots: lower bound on any bucket's slot count (must exceed
        the largest batch size fed through it).
    """

    def __init__(self, capacity_seconds: float = 3600.0, min_slots: int = 64):
        self.capacity_seconds = float(capacity_seconds)
        self.min_slots = int(min_slots)
        self.device: Optional[torch.device] = None
        # per bucket key (T_b,): device pool (n_slots+1, row_width)
        self._pools: Dict[int, torch.Tensor] = {}
        self._index: Dict[int, Dict[str, int]] = {}  # bucket -> id -> slot
        self._owner: Dict[int, List[Optional[str]]] = {}  # slot -> id
        self._ring: Dict[int, int] = {}
        self._n_slots: Dict[int, int] = {}
        self._num_buckets_hint = 1
        self.hits = 0
        self.misses = 0

    # -- geometry ---------------------------------------------------------------

    def configure(self, bucket_seconds: Sequence[float], device) -> None:
        """Record the bucket vocabulary size for capacity splitting and the
        device the pools live on (called by the augmenter). A cache serves
        one device: configuring it from a second one raises."""
        device = _canonical(device)
        if self.device is not None and self.device != device:
            raise ValueError(
                f"This DeviceSampleCache keeps its pools on {self.device}; it "
                f"cannot also serve an augmenter on {device}.")
        self.device = device
        self._num_buckets_hint = max(1, len(bucket_seconds))

    def _slots_for_bucket(self, t_b: int, sampling_rate: int) -> int:
        per_bucket_seconds = self.capacity_seconds / self._num_buckets_hint
        return max(self.min_slots, int(per_bucket_seconds * sampling_rate / t_b))

    # -- residency --------------------------------------------------------------

    def has_all(self, ids: Sequence[str], bucket_t: int) -> bool:
        idx = self._index.get(bucket_t)
        return idx is not None and all(i in idx for i in ids)

    def slots(self, ids: Sequence[str], bucket_t: int, pad_to: int) -> np.ndarray:
        """Slot vector for a fully-resident batch, padded with the scratch
        slot up to ``pad_to`` rows."""
        idx = self._index[bucket_t]
        trash = self._n_slots[bucket_t]
        out = np.full(pad_to, trash, dtype=np.int32)
        out[: len(ids)] = [idx[i] for i in ids]
        self.hits += len(ids)
        return out

    def reserve(
        self, ids: Sequence[str], bucket_t: int, pad_to: int, sampling_rate: int
    ) -> np.ndarray:
        """Assign ring slots for ``ids`` in the bucket's pool (evicting the
        previous occupants from the index), padded with the scratch slot.
        Called on the miss path; the caller writes the batch's rows in."""
        if bucket_t not in self._n_slots:
            n = self._slots_for_bucket(bucket_t, sampling_rate)
            self._n_slots[bucket_t] = n
            self._index[bucket_t] = {}
            self._owner[bucket_t] = [None] * n
            self._ring[bucket_t] = 0
        idx = self._index[bucket_t]
        owner = self._owner[bucket_t]
        n = self._n_slots[bucket_t]
        out = np.full(pad_to, n, dtype=np.int32)  # n == scratch slot
        for k, cut_id in enumerate(ids):
            slot = idx.get(cut_id)
            if slot is None:
                slot = self._ring[bucket_t]
                self._ring[bucket_t] = (slot + 1) % n
                old = owner[slot]
                if old is not None:
                    del idx[old]
                owner[slot] = cut_id
                idx[cut_id] = slot
            out[k] = slot
        self.misses += len(ids)
        return out

    # -- device side ------------------------------------------------------------

    def pool(self, bucket_t: int, wire_dtype, row_width: Optional[int] = None) -> torch.Tensor:
        """The bucket's device pool, allocated (zeroed) on first use.
        ``wire_dtype`` is a numpy or torch dtype; ``row_width`` is the
        wire-format row length in elements (defaults to ``bucket_t`` for the
        sample-per-element formats; adpcm4 rows are narrower)."""
        p = self._pools.get(bucket_t)
        if p is None:
            if self.device is None:
                raise ValueError(
                    "DeviceSampleCache has no device: pass it to an "
                    "OnDeviceAugmenter (sample_cache=...), which configures it.")
            n = self._n_slots[bucket_t]
            p = torch.zeros(
                (n + 1, bucket_t if row_width is None else row_width),
                dtype=_torch_dtype(wire_dtype), device=self.device)
            self._pools[bucket_t] = p
        return p

    def insert(self, bucket_t: int, rows: torch.Tensor, slots: np.ndarray) -> None:
        """Write wire rows already on the device into the bucket pool, in
        place (no pool copy). Duplicate scratch-slot indices are fine: that
        row is write-only."""
        pool = self.pool(bucket_t, rows.dtype, row_width=rows.shape[1])
        index = torch.as_tensor(np.asarray(slots, np.int64)).to(pool.device, non_blocking=True)
        pool.index_copy_(0, index, rows)

    # -- stats ------------------------------------------------------------------

    def memory_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self._pools.values())

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "memory_bytes": self.memory_bytes(),
            "resident_items": sum(len(i) for i in self._index.values()),
        }


def batch_cut_info(batch) -> Tuple[List[str], np.ndarray]:
    """
    ``(cut_ids, num_samples)`` per INPUT ROW of a
    ``K2SpeechRecognitionDataset(return_cuts=True)`` batch — the arguments
    :meth:`OnDeviceAugmenter.stage` needs for the cached path. Supervisions
    repeat their cut per segment; this de-duplicates by cut id preserving
    input-row order (requires every cut to carry >= 1 supervision, which
    the ASR collation guarantees for speech batches).
    """
    ids: List[str] = []
    lens: List[int] = []
    seen = set()
    for cut in batch["supervisions"]["cut"]:
        if cut.id not in seen:
            seen.add(cut.id)
            ids.append(cut.id)
            lens.append(cut.num_samples)
    return ids, np.asarray(lens, dtype=np.int64)
