"""
PerturbSpeed: per-cut random speed perturbation (copied from
``lhotse_tpu/dataset/cut_transforms/perturb_speed.py``).
"""
import random
from typing import Sequence, Union

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.utils import load_rng_state, save_rng_state


class PerturbSpeed:
    """
    With probability ``p``, perturbs the speed of each cut with a factor
    sampled uniformly from ``factors``.
    """

    def __init__(
        self, factors: Union[float, Sequence[float]], p: float, randgen: random.Random = None,
        preserve_id: bool = False) -> None:
        self.factors = factors if isinstance(factors, Sequence) else [factors]
        self.p = p
        self.random = randgen
        self.preserve_id = preserve_id

    def __call__(self, cuts: CutSet) -> CutSet:
        if self.random is None:
            self.random = random.Random()
        return CutSet.from_cuts(
            cut.perturb_speed(
                factor=self.random.choice(self.factors), affix_id=not self.preserve_id
            )
            if self.random.random() <= self.p
            else cut
            for cut in cuts
        )

    def state_dict(self) -> dict:
        return {"rng_state": save_rng_state(self.random)}

    def load_state_dict(self, sd: dict) -> None:
        self.random = load_rng_state(sd["rng_state"], self.random)
