"""
The dataset side of the PyTorch port: samplers, datasets, the loader and
the device stages. The samplers of :mod:`lhotse_tpu_torch.dataset.sampling`
are exported here, resolved at first use: ``dataset.dataloading`` reads
the rank through :mod:`lhotse_tpu_torch.parallel.mesh`, which imports this
package's stages, so importing the samplers here eagerly would be circular.
"""
_SAMPLING_NAMES = frozenset((
    "BucketingSampler", "CutSampler", "DataSource", "DynamicBucketingSampler",
    "FixedBucketBatchSizeConstraint", "SamplingConstraint", "SamplingDiagnostics",
    "SimpleCutSampler", "TimeConstraint", "estimate_duration_buckets", "find_pessimistic_batches",
    "report_padding_ratio_estimate"))

__all__ = sorted(_SAMPLING_NAMES)


def __getattr__(name: str):
    if name in _SAMPLING_NAMES:
        from lhotse_tpu_torch.dataset import sampling

        return getattr(sampling, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
