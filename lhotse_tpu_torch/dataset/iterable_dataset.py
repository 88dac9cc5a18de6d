"""
An iterable-style dataset made of a map-style dataset and a sampler
(copied from ``lhotse_tpu/dataset/iterable_dataset.py``).
:class:`IterableDatasetWrapper` subclasses ``torch.utils.data.IterableDataset``,
so ``torch.utils.data.DataLoader(wrapper, batch_size=None, ...)`` runs a
sampler replica in each worker process: the pattern for Shar data, where
the shards are split across (node, worker) pairs and every replica reads
its own. It keeps the checkpoint protocol (``state_dict``/``load_state_dict``).
"""
import warnings

from torch.utils.data import IterableDataset

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.dataloading import get_rank, get_world_size
from lhotse_tpu_torch.dataset.sampling.base import CutSampler


class IdentityDataset:
    """
    Pass-through dataset: ``__getitem__`` returns the sampled CutSet
    mini-batch unchanged. Useful when only the sampler's batching is needed.
    """

    def __getitem__(self, item):
        return item


class IterableDatasetWrapper(IterableDataset):
    """
    Makes an iterable-style dataset out of a map-style dataset + sampler —
    the pattern for tar/shar-backed data, where the sampler replica lives in
    the dataloading worker subprocess and dedup happens via shard splitting
    rather than sampler rank/world_size.

    Example::

        >>> cuts = CutSet.from_shar(in_dir="data/shar", shuffle_shards=True)
        >>> dataset = K2SpeechRecognitionDataset()
        >>> sampler = DynamicCutSampler(cuts, max_duration=200, shuffle=True)
        >>> iter_dset = IterableDatasetWrapper(dataset, sampler)
        >>> for epoch in range(10):
        ...     iter_dset.set_epoch(epoch)
        ...     for batch in iter_dset: ...
    """

    def __init__(
        self, dataset, sampler: CutSampler, auto_increment_epoch: bool = False,
        reset_on_iter: bool = False) -> None:
        super().__init__()
        self.dataset, self.sampler = dataset, sampler
        self.auto_increment_epoch = auto_increment_epoch
        self.reset_on_iter = reset_on_iter
        self.epoch, self._sampler_iter = 0, None

        rank, ws = self.sampler.rank, self.sampler.world_size
        if (rank, ws) != (0, 1):
            warnings.warn(
                f"A CutSampler with rank {rank} and world_size {ws} is being "
                f"used inside an IterableDatasetWrapper. Those settings are "
                f"meant for map-style datasets where the sampler lives in the "
                f"main training loop; with the iterable pattern, dedup happens "
                f"via shard splitting instead. If this is not intentional, "
                f"pass rank=0 and world_size=1 to the sampler's constructor.\n"
            )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.sampler.set_epoch(epoch)
        # Propagate to shard-shuffling iterators (shar/tar-backed CutSets).
        for cs in getattr(self.sampler, "cuts", None) or ():
            inner = getattr(cs, "data", None)
            if hasattr(inner, "set_epoch"):
                inner.set_epoch(epoch)

    def _refresh_sampler_iter(self, force: bool = False) -> None:
        deferred = getattr(self, "_needs_sampler_reiter", False)
        if force or deferred or self._sampler_iter is None:
            self._needs_sampler_reiter = False
            self._sampler_iter = iter(self.sampler)

    def __iter__(self):
        self._refresh_sampler_iter(force=self.reset_on_iter)
        return self

    def __next__(self) -> dict:
        # A stateful dataloader may call load_state_dict after iter(dataset):
        # honor the deferred re-iteration flag here too.
        if getattr(self, "_needs_sampler_reiter", False):
            self._refresh_sampler_iter(force=True)
        try:
            sampled = next(self._sampler_iter)
        except StopIteration:
            if self.auto_increment_epoch:
                self.set_epoch(self.epoch + 1)
            self._sampler_iter = None
            raise
        self._update_dataloading_info(sampled)
        return self.dataset[sampled]

    def state_dict(self) -> dict:
        """Stateful-protocol checkpoint of the wrapper + sampler."""
        return {"epoch": self.epoch, "sampler_state": self.sampler.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        """Restore; sampler re-iteration is deferred to stay picklable."""
        self.epoch = sd["epoch"]
        self.sampler.load_state_dict(sd["sampler_state"])
        self._needs_sampler_reiter = True

    def _update_dataloading_info(self, cuts: CutSet) -> None:
        # With iterable datasets the sampler acts as rank=0/world_size=1;
        # stamp the true distributed coordinates here.
        rank = get_rank()
        world_size = get_world_size()
        for c in cuts:
            c.dataloading_info["rank"] = rank
            c.dataloading_info["world_size"] = world_size
