"""
ExtraPadding: extra context frames, samples or seconds around each cut
(copied from ``lhotse_tpu/dataset/cut_transforms/extra_padding.py``).
"""
import random
from typing import Optional

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.utils import LOG_EPSILON, Seconds, exactly_one_not_null


class ExtraPadding:
    """
    Adds extra context frames/samples/seconds around each cut (exactly one
    unit must be specified). Useful for convolutional frame-synchronous
    models (real context instead of hidden-layer padding) and, when
    ``randomized``, as a shift augmentation under frame subsampling.
    Best placed first in the transform list.
    """

    def __init__(
        self, extra_frames: Optional[int] = None, extra_samples: Optional[int] = None,
        extra_seconds: Optional[Seconds] = None, pad_feat_value: float = LOG_EPSILON,
        randomized: bool = False, preserve_id: bool = False, direction: str = "both") -> None:
        """
        :param extra_frames/extra_samples/extra_seconds: the total amount of
            context to add (half on each side with direction="both").
        :param pad_feat_value: fill value for feature-domain padding.
        :param randomized: sample the amount uniformly in [0, extra_X] per cut.
        :param preserve_id: keep original cut IDs.
        :param direction: "both" (default), "left", or "right".
        """
        assert exactly_one_not_null(extra_frames, extra_samples, extra_seconds), (
            "For ExtraPadding, you have to specify exactly one of: frames, "
            "samples, or duration."
        )
        assert direction in ("both", "left", "right"), ("Only three padding modes are supported")
        self.extra_frames = extra_frames
        self.extra_samples = extra_samples
        self.extra_seconds = extra_seconds
        self.pad_feat_value = pad_feat_value
        self.randomized = randomized
        self.preserve_id = preserve_id
        self.direction = direction

    def _amount(self):
        """(pad kwarg name, cut attribute, sampled extra amount) per cut."""
        if self.extra_frames is not None:
            extra = self.extra_frames
            if self.randomized:
                extra = random.randint(0, extra)
            return "num_frames", extra
        if self.extra_samples is not None:
            extra = self.extra_samples
            if self.randomized:
                extra = random.randint(0, extra)
            return "num_samples", extra
        extra = self.extra_seconds
        if self.randomized:
            extra = random.uniform(0, extra)
        return "duration", extra

    def __call__(self, cuts: CutSet) -> CutSet:
        padded = []
        for cut in cuts:
            unit, extra = self._amount()
            kwargs = {unit: getattr(cut, unit) + extra}
            if unit != "num_samples":
                kwargs["pad_feat_value"] = self.pad_feat_value
            padded.append(
                cut.pad(
                    direction=self.direction,
                    preserve_id=self.preserve_id,
                    **kwargs,
                )
            )
        return CutSet.from_cuts(padded)


def maybe_sample_int(value: int, sample: bool) -> int:
    return random.randint(0, value) if sample else value


def maybe_sample_float(value: float, sample: bool) -> float:
    return random.uniform(0, value) if sample else value
