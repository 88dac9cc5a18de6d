"""
Speech-to-text translation dataset (copied from
``lhotse_tpu/dataset/speech_translation.py``).
"""
from typing import Callable, Dict, List, Union

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.input_strategies import BatchIO, PrecomputedFeatures
from lhotse_tpu_torch.dataset.speech_recognition import validate_for_asr
from lhotse_tpu_torch.utils import compute_num_frames, ifnone


class K2Speech2TextTranslationDataset:
    """
    Speech translation task dataset: like
    :class:`~lhotse_tpu_torch.dataset.speech_recognition.K2SpeechRecognitionDataset`
    but the supervisions carry both the source transcript ('text') and the
    target translation ('tgt_text' from ``supervision.custom['translated_text']``).
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
        validate_for_asr(cuts)

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
            "supervisions": { "text": [ supervision.text for cut in cuts for supervision in cut.supervisions ], "tgt_text": [ supervision.custom["translated_text"] for cut in cuts for supervision in cut.supervisions ], },
        }
        batch["supervisions"].update(supervision_intervals)
        if self.return_cuts:
            batch["supervisions"]["cut"] = [cut for cut in cuts for sup in cut.supervisions]

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
