"""
Source separation datasets (copied from
``lhotse_tpu/dataset/source_separation.py``): the base class, the
dynamically mixed and the pre-mixed variants. ``validate`` iterates the
mixtures' ``MixedCut``s, where the JAX package calls ``.values()`` on that
``CutSet`` and raises ``AttributeError``.
"""
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from lhotse_tpu_torch.cut import Cut, CutSet, MonoCut
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.utils import EPSILON


class SourceSeparationDataset:
    """
    Abstract base for source-separation datasets built from a sources CutSet
    and a mixtures CutSet. Indexed per-example (not per-batch)::

        {
            'sources': (N, T, F) array,
            'mixture': (T, F) array,
            'real_mask': (N, T, F) array,
            'binary_mask': (T, F) array,
        }
    """

    def __init__(self, sources_set: CutSet, mixtures_set: CutSet):
        warnings.warn(
            "Speech separation datasets are not yet updated to use the new "
            "sampling mechanism."
        )
        self.sources_set = sources_set
        self.mixtures_set = mixtures_set
        self.cut_ids = list(self.mixtures_set.ids)

    def _obtain_mixture(self, cut_id: str) -> Tuple[Cut, List[MonoCut]]:
        raise NotImplementedError(
            "You are using SourceSeparationDataset, which is an abstract base "
            "class; instead, use one of its derived classes that specify "
            "whether the mix is pre-computed or done dynamically (on-the-fly)."
        )

    def validate(self):
        validate(self.sources_set)
        validate(self.mixtures_set)
        for cut in self.mixtures_set.mixed_cuts:
            _, source_cuts = self._obtain_mixture(cut.id)
            assert len(source_cuts) > 1

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        mixture_cut, source_cuts = self._obtain_mixture(cut_id=self.cut_ids[idx])
        sources = np.stack([c.load_features() for c in source_cuts], axis=0)
        # Ideal ratio masks from source features (log-domain → power).
        powers = np.exp(sources)
        real_mask = powers / (powers.sum(0, keepdims=True) + EPSILON)
        return {
            "sources": sources, "mixture": mixture_cut.load_features(), "real_mask": real_mask,
            "binary_mask": real_mask.argmax(0)}

    def __len__(self):
        return len(self.cut_ids)


class DynamicallyMixedSourceSeparationDataset(SourceSeparationDataset):
    """
    On-the-fly feature-domain mixing: expects ``mixtures_set`` to contain
    MixedCuts whose tracks reference the source cuts. An optional
    ``nonsources_set`` holds mixed-in signals (e.g. noise) that are not
    separation targets.
    """

    def __init__(
        self, sources_set: CutSet, mixtures_set: CutSet, nonsources_set: Optional[CutSet] = None):
        super().__init__(sources_set=sources_set, mixtures_set=mixtures_set)
        self.nonsources_set = nonsources_set

    def validate(self):
        super().validate()
        validate(self.nonsources_set)

    def _obtain_mixture(self, cut_id: str) -> Tuple[Cut, List[MonoCut]]:
        mixture_cut = self.mixtures_set.mixed_cuts[cut_id]
        # Tracks absent from the sources set are noise.
        is_target = lambda track: track.cut.id in self.sources_set
        return mixture_cut, [t.cut for t in mixture_cut.tracks if is_target(t)]


class PreMixedSourceSeparationDataset(SourceSeparationDataset):
    """
    Time-domain pre-mixed variant: mixture and source cuts are matched by
    ``recording_id`` (assumes one recording == one utterance).
    """

    def __init__(self, sources_set: CutSet, mixtures_set: CutSet):
        self.mixture_to_source = {
            cut.id: [c.id for c in sources_set if c.recording_id == cut.recording_id]
            for cut in mixtures_set
        }
        super().__init__(sources_set=sources_set, mixtures_set=mixtures_set)

    def _obtain_mixture(self, cut_id: str) -> Tuple[Cut, List[MonoCut]]:
        mixture_cut = self.mixtures_set[cut_id]
        sources = self.mixture_to_source[mixture_cut.id]
        return mixture_cut, [self.sources_set[sid] for sid in sources]
