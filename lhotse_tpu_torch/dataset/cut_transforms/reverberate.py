"""
ReverbWithImpulseResponse: per-cut random reverberation with a given or
synthetic RIR (copied from
``lhotse_tpu/dataset/cut_transforms/reverberate.py``).
"""
import random
from typing import Iterable, List, Optional

from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.utils import load_rng_state, save_rng_state


class ReverbWithImpulseResponse:
    """
    With probability ``p``, convolves each cut with an impulse response
    chosen randomly from ``rir_recordings`` — or, when none are provided,
    synthesized with the fast random RIR generator (arXiv:2208.04101).
    ``early_only`` restricts convolution to the first 50 ms of the RIR.
    """

    def __init__(
        self, rir_recordings: Optional[Iterable[Recording]] = None, p: float = 0.5,
        normalize_output: bool = True, randgen: random.Random = None, preserve_id: bool = False,
        early_only: bool = False, rir_channels: List[int] = [0]) -> None:
        self.rir_recordings = list(rir_recordings) if rir_recordings is not None else []
        self.p = p
        self.normalize_output = normalize_output
        self.random = randgen
        self.preserve_id = preserve_id
        self.early_only = early_only
        self.rir_channels = rir_channels

    def __call__(self, cuts: CutSet) -> CutSet:
        if self.random is None:
            self.random = random.Random()
        return CutSet.from_cuts(
            cut.reverb_rir(
                rir_recording=self.random.choice(self.rir_recordings)
                if self.rir_recordings
                else None,
                normalize_output=self.normalize_output,
                early_only=self.early_only,
                affix_id=not self.preserve_id,
                rir_channels=self.rir_channels,
            )
            if self.random.random() <= self.p
            else cut
            for cut in cuts
        )

    def state_dict(self) -> dict:
        return {"rng_state": save_rng_state(self.random)}

    def load_state_dict(self, sd: dict) -> None:
        self.random = load_rng_state(sd["rng_state"], self.random)
