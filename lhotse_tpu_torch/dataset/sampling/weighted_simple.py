"""
WeightedSimpleCutSampler: ``SimpleCutSampler`` over a ``WeightedDataSource``
(copied from ``lhotse_tpu/dataset/sampling/weighted_simple.py``): per-cut
sampling weights, drawn without replacement per epoch, stopping after
``num_samples`` draws. Requires an eager CutSet.
"""
from typing import Any, Dict, List, Optional

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.sampling.data_source import WeightedDataSource
from lhotse_tpu_torch.dataset.sampling.simple import SimpleCutSampler
from lhotse_tpu_torch.utils import Seconds


class WeightedSimpleCutSampler(SimpleCutSampler):
    """
    Samples cuts with a per-cut probability given by ``cuts_weight``; an epoch
    ends after ``num_samples`` draws. Avoids duplicated cuts within an epoch
    (sampling without replacement).

    Example::

        >>> weights = get_weights(cuts)
        >>> sampler = WeightedSimpleCutSampler(
        ...     cuts, weights, num_samples=100, max_duration=200.0)
    """

    def __init__(
        self, cuts: CutSet, cuts_weight: List, num_samples: int, max_duration: Seconds = None,
        max_cuts: Optional[int] = None, shuffle: bool = False, drop_last: bool = False,
        world_size: Optional[int] = None, rank: Optional[int] = None, seed: int = 0):
        super().__init__(
            cuts=cuts, drop_last=drop_last, shuffle=shuffle, world_size=world_size, rank=rank,
            max_duration=max_duration, max_cuts=max_cuts, seed=seed)
        assert not cuts.is_lazy, "This sampler does not support lazy mode!"
        self.data_source = WeightedDataSource(
            cuts, weights=cuts_weight, num_samples=num_samples, seed=seed)
        self.weights = cuts_weight
        self.num_samples = num_samples

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        self.data_source.set_epoch(epoch)

    def state_dict(self) -> Dict[str, Any]:
        state_dict = super().state_dict()
        state_dict.update({ "weights": list(self.weights), "num_samples": self.num_samples, })
        return state_dict

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.weights = state_dict.pop("weights")
        self.num_samples = state_dict.pop("num_samples")
        # SimpleCutSampler.load_state_dict consumes time_constraint and
        # replays the data source via fast_forward.
        super().load_state_dict(state_dict)

    def __iter__(self) -> "WeightedSimpleCutSampler":
        if self._just_restored_state:
            return self
        self.diagnostics.reset_current_epoch()
        self.data_source.set_epoch(self.epoch)
        iter(self.data_source)
        return self
