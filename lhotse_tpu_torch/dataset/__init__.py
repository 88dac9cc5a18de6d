"""
The dataset side of the PyTorch port: samplers, datasets, the loader and
the device stages. The samplers of :mod:`lhotse_tpu_torch.dataset.sampling`
and the task datasets (``VadDataset``, ``DiarizationDataset``,
``K2SurtDataset``) are exported here, resolved at first use:
``dataset.dataloading`` reads the rank through
:mod:`lhotse_tpu_torch.parallel.mesh`, which imports this package's stages,
so importing them here eagerly would be circular.
"""
_SAMPLING_NAMES = frozenset((
    "BucketingSampler", "CutSampler", "DataSource", "DynamicBucketingSampler",
    "DynamicCutSampler", "FixedBucketBatchSizeConstraint", "RoundRobinSampler",
    "SamplingConstraint", "SamplingDiagnostics", "SimpleCutSampler", "StatelessSampler",
    "TimeConstraint", "WeightedDataSource", "WeightedSimpleCutSampler", "ZipSampler",
    "estimate_duration_buckets", "find_pessimistic_batches", "report_padding_ratio_estimate"))
_DATASET_MODULES = {
    "DiarizationDataset": "diarization", "K2SurtDataset": "surt", "VadDataset": "vad"}

__all__ = sorted(_SAMPLING_NAMES | set(_DATASET_MODULES))


def __getattr__(name: str):
    if name in _SAMPLING_NAMES:
        from lhotse_tpu_torch.dataset import sampling

        return getattr(sampling, name)
    if name in _DATASET_MODULES:
        import importlib

        module = importlib.import_module(f"lhotse_tpu_torch.dataset.{_DATASET_MODULES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
