"""
ClippingTransform: per-cut random amplitude clipping (copied from
``lhotse_tpu/dataset/cut_transforms/clipping.py``).
"""
import random
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.dataloading import resolve_seed
from lhotse_tpu_torch.utils import load_rng_state, save_rng_state


@dataclass
class ClippingTransform:
    """
    With probability ``p``, applies amplitude clipping (hard cutoff with
    probability ``p_hard``, else soft saturation) after boosting by
    ``gain_db`` (fixed, or uniformly sampled from an interval).
    """

    gain_db: Union[float, Tuple[float, float]]
    normalize: bool = True
    p: float = 0.5
    p_hard: float = 0.5
    seed: Union[int, str] = 42
    rng: Optional[random.Random] = None
    oversampling: Optional[int] = 2
    preserve_id: bool = False

    def __post_init__(self) -> None:
        if isinstance(self.gain_db, (tuple, list)):
            assert len(self.gain_db) == 2, (
                f"Expected gain_db to be a tuple or a list with two values, "
                f"got {self.gain_db}"
            )
            min_gain, max_gain = self.gain_db
            assert min_gain < max_gain, (
                f"Expected min_gain < max_gain, got {min_gain} >= {max_gain}"
            )

        assert 0 <= self.p <= 1, f"Probability p must be between 0 and 1, got {self.p}"

        if self.rng is not None and self.seed is not None:
            raise ValueError("Either rng or seed must be provided, not both")
        if self.rng is None:
            self.rng = random.Random(resolve_seed(self.seed))

    def __call__(self, cuts: CutSet) -> CutSet:
        saturated_cuts = []
        for cut in cuts:
            if self.rng.random() <= self.p:
                hard = self.rng.random() <= self.p_hard

                if isinstance(self.gain_db, (tuple, list)):
                    min_gain, max_gain = self.gain_db
                    gain_db = self.rng.uniform(min_gain, max_gain)
                else:
                    gain_db = self.gain_db

                new_cut = cut.clip_amplitude(
                    hard=hard, gain_db=gain_db, normalize=self.normalize,
                    affix_id=not self.preserve_id, oversampling=self.oversampling)
                saturated_cuts.append(new_cut)
            else:
                saturated_cuts.append(cut)

        return CutSet.from_cuts(saturated_cuts)

    def state_dict(self) -> dict:
        return {"rng_state": save_rng_state(self.rng)}

    def load_state_dict(self, sd: dict) -> None:
        self.rng = load_rng_state(sd["rng_state"], self.rng)
