"""
LowpassUsingResampling: per-cut random low-pass filter by resampling down
to twice a log-uniform cutoff and back (copied from
``lhotse_tpu/dataset/cut_transforms/lowpass.py``).
"""
import math
import random
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.dataloading import resolve_seed
from lhotse_tpu_torch.utils import load_rng_state, save_rng_state


@dataclass
class LowpassUsingResampling:
    """
    With probability ``p``, low-pass filters each cut by resampling down to
    ``2 × cutoff`` and back; the cutoff frequency is drawn log-uniformly from
    ``frequencies_interval``.
    """

    p: float = 0.5
    frequencies_interval: Tuple[float, float] = (3500, 8000)
    seed: Union[int, str] = 42
    rng: Optional[random.Random] = None
    preserve_id: bool = False

    def __post_init__(self) -> None:
        if self.rng is not None and self.seed is not None:
            raise ValueError("Either rng or seed must be provided, not both")
        if self.rng is None:
            self.rng = random.Random(resolve_seed(self.seed))

    def __call__(self, cuts: CutSet) -> CutSet:
        lowpassed_cuts = []
        for cut in cuts:
            if self.rng.random() <= self.p:
                low, high = self.frequencies_interval
                if high > cut.sampling_rate // 2:
                    raise ValueError(
                        f"Upper frequency limit {high} is greater than "
                        f"sampling rate / 2 ({cut.sampling_rate // 2})"
                    )

                cutoff_frequency = int(math.exp(self.rng.uniform(math.log(low), math.log(high))))
                new_cut = cut.resample(cutoff_frequency * 2).resample(cut.sampling_rate)
                if not self.preserve_id:
                    new_cut.id = f"{cut.id}_lowpassed{cutoff_frequency:.0f}"
                lowpassed_cuts.append(new_cut)
            else:
                lowpassed_cuts.append(cut)

        return CutSet.from_cuts(lowpassed_cuts)

    def state_dict(self) -> dict:
        return {"rng_state": save_rng_state(self.rng)}

    def load_state_dict(self, sd: dict) -> None:
        self.rng = load_rng_state(sd["rng_state"], self.rng)
