"""
PerturbVolume: per-cut random gain (copied from
``lhotse_tpu/dataset/cut_transforms/perturb_volume.py``).
"""
import random

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.utils import load_rng_state, save_rng_state


class PerturbVolume:
    """
    With probability ``p``, scales the volume of each cut by a factor drawn
    uniformly from ``[scale_low, scale_high]``.
    """

    def __init__(
        self, p: float, scale_low: float = 0.125, scale_high: float = 2.0,
        randgen: random.Random = None, preserve_id: bool = False) -> None:
        self.p = p
        self.scale_low = scale_low
        self.scale_high = scale_high
        self.random = randgen
        self.preserve_id = preserve_id

    def __call__(self, cuts: CutSet) -> CutSet:
        if self.random is None:
            self.random = random.Random()
        return CutSet.from_cuts(
            cut.perturb_volume(
                factor=self._uniform(self.scale_low, self.scale_high),
                affix_id=not self.preserve_id,
            )
            if self.random.random() <= self.p
            else cut
            for cut in cuts
        )

    def _uniform(self, low: float, high: float) -> float:
        return low + self.random.random() * (high - low)

    def state_dict(self) -> dict:
        return {"rng_state": save_rng_state(self.random)}

    def load_state_dict(self, sd: dict) -> None:
        self.random = load_rng_state(sd["rng_state"], self.random)
