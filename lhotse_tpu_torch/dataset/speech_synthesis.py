"""
Speech synthesis (TTS) dataset and ``validate_for_tts`` (copied from
``lhotse_tpu/dataset/speech_synthesis.py``).
"""
from typing import Callable, Dict, List, Sequence, Union

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.collation import collate_audio
from lhotse_tpu_torch.dataset.input_strategies import BatchIO, PrecomputedFeatures
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.utils import ifnone


class SpeechSynthesisDataset:
    """
    TTS task dataset::

        {
            'audio': (B, T) float array,
            'features': (B, NumFrames, NumFeatures) float array,
            'audio_lens': (B,) int array,
            'features_lens': (B,) int array,
            'text': List[str]                     # when return_text=True
            'tokens': List[List[str]]             # when return_tokens=True
            'speakers': List[str]                 # when return_spk_ids=True
            'cut': List[Cut]                      # when return_cuts=True
        }
    """

    def __init__(
        self, cut_transforms: List[Callable[[CutSet], CutSet]] = None,
        feature_input_strategy: BatchIO = None,
        feature_transforms: Union[Sequence[Callable], Callable] = None, return_text: bool = True,
        return_tokens: bool = False, return_spk_ids: bool = False, return_cuts: bool = False,
    ) -> None:
        self.cut_transforms = ifnone(cut_transforms, [])
        self.feature_input_strategy = (
            feature_input_strategy
            if feature_input_strategy is not None
            else PrecomputedFeatures()
        )

        self.return_text = return_text
        self.return_tokens = return_tokens
        self.return_spk_ids = return_spk_ids
        self.return_cuts = return_cuts

        if feature_transforms is None:
            feature_transforms = []
        elif not isinstance(feature_transforms, Sequence):
            feature_transforms = [feature_transforms]

        assert all(callable(transform) for transform in feature_transforms), (
            "Feature transforms must be Callable"
        )
        self.feature_transforms = feature_transforms

    def __getitem__(self, cuts: CutSet) -> Dict[str, np.ndarray]:
        validate_for_tts(cuts)

        for transform in self.cut_transforms:
            cuts = transform(cuts)

        audio, audio_lens = collate_audio(cuts)
        features, features_lens = self.feature_input_strategy(cuts)

        for transform in self.feature_transforms:
            features = transform(features)

        batch = {
            "audio": audio, "features": features, "audio_lens": audio_lens,
            "features_lens": features_lens}

        if self.return_text:
            batch["text"] = [
                getattr(cut.supervisions[0], "normalized_text", None)
                or cut.supervisions[0].text
                for cut in cuts
            ]

        if self.return_tokens:
            batch["tokens"] = [cut.tokens for cut in cuts]

        if self.return_spk_ids:
            batch["speakers"] = [cut.supervisions[0].speaker for cut in cuts]

        if self.return_cuts:
            batch["cut"] = [cut for cut in cuts]

        return batch


def validate_for_tts(cuts: CutSet) -> None:
    validate(cuts)
    for cut in cuts:
        assert len(cut.supervisions) == 1, ("Only the Cuts with single supervision are supported.")
