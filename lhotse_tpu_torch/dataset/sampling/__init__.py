from lhotse_tpu_torch.dataset.sampling.base import (
    CutSampler, EpochDiagnostics, SamplingConstraint, SamplingDiagnostics, TimeConstraint,
    TokenConstraint)
from lhotse_tpu_torch.dataset.sampling.bucketing import BucketingSampler
from lhotse_tpu_torch.dataset.sampling.checkpoint_backends import (
    IndexedCheckpointBackend, ReplayCheckpointBackend)
from lhotse_tpu_torch.dataset.sampling.cut_pairs import CutPairsSampler
from lhotse_tpu_torch.dataset.sampling.data_source import DataSource, WeightedDataSource
from lhotse_tpu_torch.dataset.sampling.dynamic import DurationBatcher, DynamicCutSampler
from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
    DynamicBucketingSampler, FixedBucketBatchSizeConstraint, estimate_duration_buckets)
from lhotse_tpu_torch.dataset.sampling.round_robin import RoundRobinSampler
from lhotse_tpu_torch.dataset.sampling.simple import SimpleCutSampler
from lhotse_tpu_torch.dataset.sampling.stateless import StatelessSampler
from lhotse_tpu_torch.dataset.sampling.utils import (
    find_pessimistic_batches, report_padding_ratio_estimate)
from lhotse_tpu_torch.dataset.sampling.weighted_simple import WeightedSimpleCutSampler
from lhotse_tpu_torch.dataset.sampling.zip import ZipSampler

__all__ = [
    "BucketingSampler", "CutPairsSampler", "CutSampler", "DataSource", "DurationBatcher",
    "DynamicBucketingSampler", "DynamicCutSampler", "EpochDiagnostics",
    "FixedBucketBatchSizeConstraint", "IndexedCheckpointBackend", "ReplayCheckpointBackend",
    "RoundRobinSampler", "SamplingConstraint", "SamplingDiagnostics", "SimpleCutSampler",
    "StatelessSampler", "TimeConstraint", "TokenConstraint", "WeightedDataSource",
    "WeightedSimpleCutSampler", "ZipSampler", "estimate_duration_buckets",
    "find_pessimistic_batches", "report_padding_ratio_estimate"]
