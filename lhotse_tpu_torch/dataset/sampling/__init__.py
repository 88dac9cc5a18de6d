from lhotse_tpu_torch.dataset.sampling.base import (
    CutSampler, SamplingConstraint, SamplingDiagnostics, TimeConstraint)
from lhotse_tpu_torch.dataset.sampling.bucketing import BucketingSampler
from lhotse_tpu_torch.dataset.sampling.data_source import DataSource
from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
    DynamicBucketingSampler, FixedBucketBatchSizeConstraint, estimate_duration_buckets)
from lhotse_tpu_torch.dataset.sampling.simple import SimpleCutSampler
from lhotse_tpu_torch.dataset.sampling.utils import (
    find_pessimistic_batches, report_padding_ratio_estimate)

__all__ = [
    "BucketingSampler", "CutSampler", "DataSource", "DynamicBucketingSampler",
    "FixedBucketBatchSizeConstraint", "SamplingConstraint", "SamplingDiagnostics",
    "SimpleCutSampler", "TimeConstraint", "estimate_duration_buckets", "find_pessimistic_batches",
    "report_padding_ratio_estimate"]
