"""
Multi-talker ASR dataset (copied from ``lhotse_tpu/dataset/surt.py``; SURT,
MT-RNNT and SOT styles). Supervisions are split into N output channels by
start time (heuristic error assignment training, HEAT — Lu et al. 2021,
IEEE SPL 28). Its ``validate_for_asr`` compares each supervision's
duration, not its end, with the cut's duration, as the JAX package's does.
"""
from collections import defaultdict
from typing import Callable, Dict, List, Union

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.input_strategies import BatchIO, PrecomputedFeatures
from lhotse_tpu_torch.qa import validate
from lhotse_tpu_torch.utils import LOG_EPSILON, compute_num_frames, ifnone


class K2SurtDataset:
    """
    Multi-talker ASR batches::

        {
            'inputs': (B, T, F) features or (B, T) audio,
            'input_lens': (B,) int array,
            'supervisions': List[List[List[SupervisionSegment]]]
                (batch → channel → segments; channels may be empty),
            'text': List[List[str]] (batch → channel, delimiter-joined),
            'cuts': CutSet (when return_cuts=True),
            'source_feats'/'source_boundaries' (when return_sources=True),
        }
    """

    def __init__(
        self, return_cuts: bool = False, return_sources: bool = False,
        return_alignments: bool = False, num_channels: int = 2, text_delimiter: str = " ",
        cut_transforms: List[Callable[[CutSet], CutSet]] = None,
        input_transforms: List[Callable] = None, input_strategy: BatchIO = None,
        pad_value: float = LOG_EPSILON, strict: bool = False):
        """
        :param num_channels: number of output branches; supervisions are
            assigned to the first channel free at their start time.
        :param strict: drop cuts with more simultaneous speakers than
            channels (otherwise assign to the earliest-ending channel).
        :param return_sources: also return per-segment source features and
            frame boundaries (requires 'source_feats' TemporalArray and
            'source_feat_offsets' custom fields on the cuts).
        """
        self.return_cuts, self.return_sources = return_cuts, return_sources
        self.return_alignments = return_alignments
        self.num_channels, self.text_delimiter = num_channels, text_delimiter
        self.cut_transforms = ifnone(cut_transforms, [])
        self.input_transforms = ifnone(input_transforms, [])
        self.input_strategy = ifnone(input_strategy, PrecomputedFeatures())
        self.pad_value, self.strict = pad_value, strict

    def __getitem__(self, cuts: CutSet) -> Dict[str, Union[np.ndarray, List]]:
        validate_for_asr(cuts)

        if not self.return_alignments:
            cuts = cuts.drop_alignments()

        cuts = cuts.sort_by_duration(ascending=False)

        for tnfm in self.cut_transforms:
            cuts = tnfm(cuts)

        # HEAT channel assignment: first channel that is empty or whose last
        # supervision ended before this one starts.
        supervisions = defaultdict(list)
        invalid_cuts, source_feats, source_boundaries = [], [], []

        for cut in cuts:
            cut_sups = [[] for _ in range(self.num_channels)]
            last_sup_end = [0.0] * self.num_channels
            cut_sources, cut_source_boundaries = [], []
            invalid_cut = False

            def place(sup) -> bool:
                """HEAT: first free channel, else earliest-ending (overlap)."""
                for ch, (members, busy_until) in enumerate(zip(cut_sups, last_sup_end)):
                    if not members or busy_until <= sup.start:
                        chosen, clean = ch, True
                        break
                else:
                    chosen, clean = last_sup_end.index(min(last_sup_end)), False
                cut_sups[chosen].append(sup)
                last_sup_end[chosen] = max(last_sup_end[chosen], sup.end)
                return clean

            for sup in sorted(cut.supervisions, key=lambda s: s.start):
                if not place(sup):
                    invalid_cut = True

            if self.return_sources:
                source_feat_offsets = cut.source_feat_offsets
                assert len(source_feat_offsets) == len(cut.supervisions), (
                    "The number of source feature offsets should be equal to "
                    "the number of supervisions. Got "
                    f"{len(source_feat_offsets)} offsets for "
                    f"{len(cut.supervisions)} supervisions."
                )
                cut_sources = list(np.split(cut.load_source_feats(), source_feat_offsets[1:]))
                cut_source_boundaries = [
                    (
                        compute_num_frames(sup.start, cut.frame_shift, cut.sampling_rate),
                        compute_num_frames(sup.end, cut.frame_shift, cut.sampling_rate),
                    )
                    for sup in sorted(cut.supervisions, key=lambda s: (s.start, s.speaker))
                ]
                cut_sources = [
                    adjust_source_feats(x, end - start, padding_value=self.pad_value) for x,
                    (start, end) in zip(cut_sources, cut_source_boundaries)]

            if invalid_cut and self.strict:
                invalid_cuts.append(cut.id)
                continue
            supervisions[cut.id] = cut_sups
            if self.return_sources:
                source_feats.append(cut_sources)
                source_boundaries.append(cut_source_boundaries)

        if len(invalid_cuts) > 0:
            print(
                f"WARNING: {len(invalid_cuts)} cuts were removed out of "
                f"{len(cuts)} due to more overlapping speakers than channels."
            )
            cuts = cuts.filter(lambda cut: cut.id not in invalid_cuts).to_eager()

        input_tpl = self.input_strategy(cuts)
        if len(input_tpl) == 3:
            inputs, input_lens, cuts = input_tpl
        else:
            inputs, input_lens = input_tpl

        def channel_texts(cut_sups):
            return [
                self.text_delimiter.join(sup.text.strip() for sup in sups_ch)
                for sups_ch in cut_sups
            ]

        batch = {
            "inputs": inputs, "input_lens": input_lens, "supervisions": list(supervisions.values()),
            "text": [channel_texts(cs) for cs in supervisions.values()]}
        if self.return_cuts:
            batch["cuts"] = cuts
        if self.return_sources:
            batch.update(source_feats=source_feats, source_boundaries=source_boundaries)
        return batch


def adjust_source_feats(
    feats: np.ndarray, num_frames: int, padding_value: float = 0.0, tol: int = 2) -> np.ndarray:
    """
    Pad or trim source features to exactly ``num_frames`` (off-by-``tol``
    mismatches only; larger gaps raise).
    """
    if feats.shape[0] == num_frames:
        return feats
    elif abs(feats.shape[0] - num_frames) > tol:
        raise ValueError(
            f"Number of frames in the source features ({feats.shape[0]}) is "
            f"not close to the number of frames in the supervision ({num_frames})."
        )
    elif feats.shape[0] < num_frames:
        pad = np.full((num_frames - feats.shape[0], feats.shape[1]), padding_value, feats.dtype)
        return np.concatenate([feats, pad], axis=0)
    else:
        return feats[:num_frames]


def validate_for_asr(cuts: CutSet) -> None:
    validate(cuts)
    tol = 2e-3  # 1ms
    for cut in cuts:
        for supervision in cut.supervisions:
            assert supervision.start >= -tol, (
                f"Supervisions starting before the cut are not supported for ASR"
                f" (sup id: {supervision.id}, cut id: {cut.id})"
            )
            assert supervision.duration <= cut.duration + tol, (
                f"Supervisions ending after the cut are not supported for ASR"
                f" (sup id: {supervision.id}, cut id: {cut.id})"
            )
