"""
Voice activity detection dataset (copied from ``lhotse_tpu/dataset/vad.py``):
features and a (B, T) ``is_voice`` mask of the frames covered by a
supervision.
"""
from typing import Callable, Dict, Sequence

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.input_strategies import BatchIO, PrecomputedFeatures
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.utils import ifnone


class VadDataset:
    """
    VAD task dataset::

        {
            'inputs': (B, T, F) array,
            'input_lens': (B,) array,
            'is_voice': (B, T) array,
            'cut': CutSet,
        }
    """

    def __init__(
        self, input_strategy: BatchIO = None,
        cut_transforms: Sequence[Callable[[CutSet], CutSet]] = None,
        input_transforms: Sequence[Callable] = None) -> None:
        self.input_strategy = (
            input_strategy if input_strategy is not None else PrecomputedFeatures()
        )
        self.cut_transforms = ifnone(cut_transforms, [])
        self.input_transforms = ifnone(input_transforms, [])

    def __getitem__(self, cuts: CutSet) -> Dict[str, np.ndarray]:
        validate(cuts)
        cuts = cuts.sort_by_duration()
        for tfnm in self.cut_transforms:
            cuts = tfnm(cuts)
        inputs, input_lens = self.input_strategy(cuts)
        for tfnm in self.input_transforms:
            inputs = tfnm(inputs)
        return {
            "inputs": inputs, "input_lens": input_lens,
            "is_voice": self.input_strategy.supervision_masks(cuts), "cut": cuts}
