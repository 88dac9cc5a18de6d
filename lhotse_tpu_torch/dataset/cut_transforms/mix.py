"""
CutMix: per-batch noise mixing through ``CutSet.mix`` (copied from
``lhotse_tpu/dataset/cut_transforms/mix.py``).
"""
import random
import warnings
from typing import Optional, Tuple, Union

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.dataloading import resolve_seed
from lhotse_tpu_torch.utils import Decibels, load_rng_state, save_rng_state


class CutMix:
    """
    Stochastic noise augmentation: mixes randomly chosen cuts from a noise
    CutSet into each batch at a constant or uniformly-sampled SNR.
    """

    def __init__(
        self, cuts: CutSet, snr: Optional[Union[Decibels, Tuple[Decibels, Decibels]]] = (10, 20),
        p: float = 0.5, pad_to_longest: bool = True, preserve_id: bool = False,
        seed: Union[int, str, random.Random] = 42, random_mix_offset: bool = False,
        tag: Optional[str] = None) -> None:
        """
        :param cuts: CutSet with augmentation data (noise, music, babble).
        :param snr: float (fixed), (low, high) range (uniform sample), or
            None (mix as-is, no level adjustment — different from snr=0).
        :param pad_to_longest: pad each cut with noise up to the longest cut
            in the batch.
        :param preserve_id: keep the original cut IDs after augmentation.
        :param seed: int / "trng" / "randomized" / a random.Random instance.
        :param random_mix_offset: when the mixed-in cut is longer, take a
            random sub-region instead of its beginning.
        :param tag: optional label attached to the mixed-in tracks.
        """
        if len(cuts) == 0:
            warnings.warn("Empty CutSet in CutMix transform: it'll act as an identity transform.")
        self.cuts, self.snr, self.p = cuts, snr, p
        self.pad_to_longest, self.preserve_id = pad_to_longest, preserve_id
        self.random_mix_offset, self.tag = random_mix_offset, tag
        self.seed, self.rng = seed, None

    def _rng(self) -> random.Random:
        if self.rng is None:
            self.rng = (
                self.seed
                if isinstance(self.seed, random.Random)
                else random.Random(resolve_seed(self.seed))
            )
        return self.rng

    def __call__(self, cuts: CutSet) -> CutSet:
        if len(self.cuts) == 0:  # identity when there is nothing to mix in
            return cuts
        pad_target = max(c.duration for c in cuts) if self.pad_to_longest else None
        mixed = cuts.mix(
            cuts=self.cuts, duration=pad_target, snr=self.snr, mix_prob=self.p,
            preserve_id="left" if self.preserve_id else None, seed=self._rng(),
            random_mix_offset=self.random_mix_offset, tag=self.tag)
        return mixed.to_eager()

    def state_dict(self) -> dict:
        return {"rng_state": save_rng_state(self.rng)}

    def load_state_dict(self, sd: dict) -> None:
        self.rng = load_rng_state(sd["rng_state"], self.rng)
