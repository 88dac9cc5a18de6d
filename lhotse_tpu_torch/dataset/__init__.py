"""
The dataset side of the PyTorch port: samplers, datasets, the loader and
the device stages. The samplers of :mod:`lhotse_tpu_torch.dataset.sampling`,
the task datasets (``VadDataset``, ``DiarizationDataset``, ``K2SurtDataset``,
``K2Speech2TextTranslationDataset``, the source separation datasets,
``SpeechSynthesisDataset``, ``AudioTaggingDataset`` and the unsupervised
datasets with their chunk collation and worker sharding),
``TokenCollater``/``collate_custom_field`` and the WebDataset writer and
reader are exported here, resolved at
first use:
``dataset.dataloading`` reads the rank through
:mod:`lhotse_tpu_torch.parallel.mesh`, which imports this package's stages,
so importing them here eagerly would be circular.
"""
_SAMPLING_NAMES = frozenset((
    "BucketingSampler", "CutPairsSampler", "CutSampler", "DataSource", "DynamicBucketingSampler",
    "DynamicCutSampler", "FixedBucketBatchSizeConstraint", "RoundRobinSampler",
    "SamplingConstraint", "SamplingDiagnostics", "SimpleCutSampler", "StatelessSampler",
    "TimeConstraint", "WeightedDataSource", "WeightedSimpleCutSampler", "ZipSampler",
    "estimate_duration_buckets", "find_pessimistic_batches", "report_padding_ratio_estimate"))
_DATASET_MODULES = {
    "AudioTaggingDataset": "audio_tagging", "DiarizationDataset": "diarization",
    "DynamicUnsupervisedDataset": "unsupervised",
    "DynamicallyMixedSourceSeparationDataset": "source_separation",
    "K2Speech2TextTranslationDataset": "speech_translation", "K2SurtDataset": "surt",
    "LazyWebdatasetIterator": "webdataset",
    "PreMixedSourceSeparationDataset": "source_separation",
    "RecordingChunkIterableDataset": "unsupervised", "SourceSeparationDataset": "source_separation",
    "SpeechSynthesisDataset": "speech_synthesis", "TokenCollater": "collation",
    "UnsupervisedDataset": "unsupervised", "UnsupervisedWaveformDataset": "unsupervised",
    "VadDataset": "vad", "WebdatasetWriter": "webdataset", "audio_chunk_collate": "unsupervised",
    "audio_chunk_worker_init_fn": "unsupervised", "collate_custom_field": "collation",
    "export_to_webdataset": "webdataset", "validate_for_tts": "speech_synthesis"}

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
