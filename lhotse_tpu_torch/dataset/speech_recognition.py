"""
The ASR task dataset (copied from
``lhotse_tpu/dataset/speech_recognition.py``): query it with CutSet
mini-batches from a sampler; it validates them, loads the inputs through
its input strategy and collates the supervisions into a dict of numpy
arrays and lists, the host staging format of the device augmenter.
"""
from typing import Callable, Dict, List, Union

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.input_strategies import BatchIO, PrecomputedFeatures
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.utils import compute_num_frames, ifnone


class K2SpeechRecognitionDataset:
    """
    Speech-recognition dataset (named for parity with the k2-style batch
    layout). Query it with CutSet mini-batches from a sampler; it loads
    inputs and collates supervisions.

    Each item is a dict::

        {
            'inputs': float array (B, T, F) for features or (B, T) for audio,
            'supervisions': {
                'sequence_idx': int array (S,),
                'text': List[str] of len S,
                'start_frame'/'num_frames' or 'start_sample'/'num_samples':
                    int arrays (S,),
                'cut': List[Cut] (only when return_cuts=True),
            }
        }

    where B = batch size, S = total supervisions (>= B), T = padded length.
    """

    def __init__(
        self, return_cuts: bool = False, cut_transforms: List[Callable[[CutSet], CutSet]] = None,
        input_transforms: List[Callable] = None, input_strategy: BatchIO = None):
        """
        :param return_cuts: include a "cut" list in each batch's supervisions.
        :param cut_transforms: transforms on the CutSet before input
            conversion (concatenation, noise mixing, ...).
        :param input_transforms: transforms on the collated inputs
            (normalization, SpecAugment, ...).
        :param input_strategy: converts cuts into collated audio/features
            (default: PrecomputedFeatures).
        """
        self.return_cuts = return_cuts
        self.cut_transforms = ifnone(cut_transforms, [])
        self.input_transforms = ifnone(input_transforms, [])
        self.input_strategy = ifnone(input_strategy, PrecomputedFeatures())

    def __getitem__(self, cuts: CutSet) -> Dict[str, Union[np.ndarray, List[str]]]:
        validate_for_asr(cuts)

        # The longest cut determines the batch's padded time dimension.
        cuts = cuts.sort_by_duration(ascending=False)

        for tnfm in self.cut_transforms:
            cuts = tnfm(cuts)

        cuts = cuts.sort_by_duration(ascending=False)

        input_tpl = self.input_strategy(cuts)
        if len(input_tpl) == 3:
            # Fault-tolerant mode: "cuts" may have shrunk to the readable ones.
            inputs, _, cuts = input_tpl
        else:
            inputs, _ = input_tpl

        intervals = self.input_strategy.supervision_intervals(cuts)
        segments = np.stack(list(intervals.values()), axis=1)
        for tnfm in self.input_transforms:
            inputs = tnfm(inputs, supervision_segments=segments)

        per_sup = [(cut, sup) for cut in cuts for sup in cut.supervisions]
        supervisions = {"text": [sup.text for _, sup in per_sup], **intervals}
        if self.return_cuts:
            supervisions["cut"] = [cut for cut, _ in per_sup]
        batch = {"inputs": inputs, "supervisions": supervisions}

        has_word_alignments = all(
            s.alignment is not None and "word" in s.alignment
            for c in cuts
            for s in c.supervisions
        )
        if has_word_alignments:
            cuts_list = list(cuts)
            frame_shift = cuts_list[0].frame_shift
            sampling_rate = cuts_list[0].sampling_rate
            if frame_shift is None:
                try:
                    frame_shift = self.input_strategy.extractor.frame_shift
                except AttributeError:
                    raise ValueError(
                        "Can't determine the frame_shift -- it is not present "
                        "either in cuts or the input_strategy. "
                    )

            def to_frame(secs):
                return compute_num_frames(
                    secs, frame_shift=frame_shift, sampling_rate=sampling_rate)

            word_alis = [s.alignment["word"] for c in cuts_list for s in c.supervisions]
            batch["supervisions"]["word"] = [[item.symbol for item in ali] for ali in word_alis]
            batch["supervisions"]["word_start"] = [
                [to_frame(item.start) for item in ali] for ali in word_alis
            ]
            batch["supervisions"]["word_end"] = [
                [to_frame(item.end) for item in ali] for ali in word_alis
            ]

        return batch


def validate_for_asr(cuts: CutSet) -> None:
    validate(cuts)
    tol = 2e-3  # 1ms
    for cut in cuts:
        for supervision in cut.supervisions:
            assert supervision.start >= -tol, (
                f"Supervisions starting before the cut are not supported for ASR"
                f" (sup id: {supervision.id}, cut id: {cut.id})"
            )
            assert supervision.end <= cut.duration + tol, (
                f"Supervisions ending after the cut are not supported for ASR"
                f" (sup id: {supervision.id}, cut id: {cut.id})"
            )
