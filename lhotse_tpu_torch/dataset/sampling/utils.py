"""
Sampler diagnostics (copied from ``lhotse_tpu/dataset/sampling/utils.py``):
``find_pessimistic_batches``, the batches most likely to exhaust device
memory under several criteria, and ``report_padding_ratio_estimate``.
"""
import warnings
from statistics import mean
from typing import Dict, Tuple

import numpy as np

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.sampling.base import CutSampler

# criterion name -> batch "badness" measure (higher = more pessimistic).
_CRITERIA = {
    "single_longest_cut": lambda cuts: max(c.duration for c in cuts),
    "single_longest_supervision": lambda cuts: max( sum(s.duration for s in c.supervisions) for c in cuts ),
    "largest_batch_cuts_duration": lambda cuts: sum(c.duration for c in cuts),
    "largest_batch_supervisions_duration": lambda cuts: sum( s.duration for c in cuts for s in c.supervisions ),
    "max_num_cuts": len,
    "max_num_supervisions": lambda cuts: sum( 1 for c in cuts for _ in c.supervisions )}


def find_pessimistic_batches(
    sampler: CutSampler, batch_tuple_index: int = 0) -> Tuple[Dict[str, CutSet], Dict[str, float]]:
    """
    Fully iterate ``sampler`` and record the batches most likely to blow up
    accelerator memory, under several criteria (longest cut, longest
    supervision, largest total duration, max cut/supervision counts).
    Returns ``({criterion: CutSet}, {criterion: value})``.
    """
    worst = {}  # criterion -> (value, batch)
    for batch in iter(sampler):
        if isinstance(batch, tuple):
            batch = batch[batch_tuple_index]
        for crit, measure in _CRITERIA.items():
            value = measure(batch)
            if crit not in worst or value > worst[crit][0]:
                worst[crit] = (value, batch)
    if not worst:
        warnings.warn("Empty sampler encountered in find_pessimistic_batches()")
        return {}, {}
    return (
        {crit: batch for crit, (_, batch) in worst.items()},
        {crit: value for crit, (value, _) in worst.items()})


def _fmt(values) -> str:
    """'<mean>s (std=<std>s)' over a list of durations."""
    return f"{np.mean(values):.1f}s (std={np.std(values):.1f}s)"


def report_padding_ratio_estimate(sampler: CutSampler, n_samples: int = 1000) -> str:
    """
    Human-readable padding diagnostics over ``n_samples`` batches, assuming
    padding corresponds to segments without supervisions within cuts.
    """
    per_cut = {"sup": [], "tot": [], "gap": []}
    per_batch = {"sup": [], "tot": [], "gap": []}
    spread = {"min": [], "mean": [], "max": []}

    stream = iter(sampler)
    for _ in range(n_samples):
        try:
            batch = next(stream)
        except StopIteration:
            break
        if not isinstance(batch, CutSet):
            warnings.warn(
                "The sampler returned a mini-batch with multiple CutSets: we "
                "will only report the padding estimate for the first CutSet in "
                "each mini-batch."
            )
            batch = batch[0]

        ordered = list(batch.sort_by_duration(ascending=False))
        if len(ordered) > 1:
            longest = ordered[0].duration
            spread["min"].append((longest - ordered[1].duration) / longest)
            spread["max"].append((longest - ordered[-1].duration) / longest)
            spread["mean"].append(mean(longest - c.duration for c in ordered[1:]) / longest)

        totals = supers = 0.0
        for cut in batch.pad():
            sup = sum(s.duration for s in cut.supervisions)
            per_cut["tot"].append(cut.duration)
            per_cut["sup"].append(sup)
            per_cut["gap"].append(cut.duration - sup)
            totals += cut.duration
            supers += sup
        per_batch["tot"].append(totals)
        per_batch["sup"].append(supers)
        per_batch["gap"].append(totals - supers)

    cut_pad_pct = np.mean(per_cut["gap"]) / np.mean(per_cut["tot"])
    batch_pad_pct = np.mean(per_batch["gap"]) / np.mean(per_batch["tot"])
    return f"""An average CUT has {_fmt(per_cut['sup'])} of supervisions vs. {_fmt(per_cut['tot'])} of total duration. Average padding is {_fmt(per_cut['gap'])}, i.e. {cut_pad_pct:.1%}.
An average BATCH has {_fmt(per_batch['sup'])} of combined supervised duration vs. {_fmt(per_batch['tot'])} of combined total duration. Average padding is {_fmt(per_batch['gap'])}, i.e. {batch_pad_pct:.1%}.
Expected variability of cut durations within a single batch is +/-{np.mean(spread['mean']):.1%} (two closest cuts: {np.mean(spread['min']):.1%}, two most distant cuts: {np.mean(spread['max']):.1%}).
    """
