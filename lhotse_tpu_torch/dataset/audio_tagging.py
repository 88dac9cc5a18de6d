"""
Audio tagging dataset (copied from ``lhotse_tpu/dataset/audio_tagging.py``).
"""
from typing import Callable, Dict, List, Union

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.input_strategies import BatchIO, PrecomputedFeatures
from lhotse_tpu_torch.utils import ifnone


class AudioTaggingDataset:
    """
    Audio tagging task dataset::

        {
            'inputs': (B, T, F) features or (B, T) audio,
            'supervisions': {
                'audio_event': List[str]  (semicolon-separated event labels),
                'sequence_idx', 'start_frame'/'num_frames' or
                'start_sample'/'num_samples': int arrays,
                'cut': List[Cut] (when return_cuts=True),
            }
        }
    """

    def __init__(
        self, return_cuts: bool = False, cut_transforms: List[Callable[[CutSet], CutSet]] = None,
        input_transforms: List[Callable] = None, input_strategy: BatchIO = None):
        self.return_cuts = return_cuts
        self.cut_transforms = ifnone(cut_transforms, [])
        self.input_transforms = ifnone(input_transforms, [])
        self.input_strategy = (
            input_strategy if input_strategy is not None else PrecomputedFeatures()
        )

    def __getitem__(self, cuts: CutSet) -> Dict[str, Union[np.ndarray, List[str]]]:
        cuts = cuts.sort_by_duration(ascending=False)

        for tnfm in self.cut_transforms:
            cuts = tnfm(cuts)

        cuts = cuts.sort_by_duration(ascending=False)

        input_tpl = self.input_strategy(cuts)
        if len(input_tpl) == 3:
            inputs, _, cuts = input_tpl
        else:
            inputs, _ = input_tpl

        supervision_intervals = self.input_strategy.supervision_intervals(cuts)

        segments = np.stack(list(supervision_intervals.values()), axis=1)
        for tnfm in self.input_transforms:
            inputs = tnfm(inputs, supervision_segments=segments)

        batch = {
            "inputs": inputs,
            "supervisions": { "audio_event": [ supervision.audio_event for cut in cuts for supervision in cut.supervisions ], },
        }
        batch["supervisions"].update(supervision_intervals)
        if self.return_cuts:
            batch["supervisions"]["cut"] = [cut for cut in cuts for sup in cut.supervisions]

        return batch
