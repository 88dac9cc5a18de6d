from lhotse_tpu_torch.dataset.sampling.base import (
    CutSampler, SamplingConstraint, SamplingDiagnostics, TimeConstraint)
from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
    DynamicBucketingSampler, FixedBucketBatchSizeConstraint, estimate_duration_buckets)

__all__ = [
    "CutSampler", "DynamicBucketingSampler", "FixedBucketBatchSizeConstraint", "SamplingConstraint",
    "SamplingDiagnostics", "TimeConstraint", "estimate_duration_buckets"]
