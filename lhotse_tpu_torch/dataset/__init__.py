"""
The dataset side of the PyTorch port: samplers, datasets, the loader and
the device stages. Every name the JAX package's ``lhotse_tpu.dataset``
exports and the port has is exported here (the samplers and constraints of
:mod:`lhotse_tpu_torch.dataset.sampling`, the cut transforms, the input
strategies, the collation functions, the batch signal transforms, the task
datasets, ``DataLoader`` and the dataloading helpers), resolved at first
use: ``dataset.dataloading`` reads the rank through
:mod:`lhotse_tpu_torch.parallel.mesh`, which imports this package's stages,
so importing them here eagerly would be circular.
"""
_SUBMODULES = frozenset(("collation", "input_strategies", "signal_transforms"))
_MODULES = {
    "sampling": (
        "BucketingSampler", "CutPairsSampler", "CutSampler", "DataSource", "DurationBatcher",
        "DynamicBucketingSampler", "DynamicCutSampler", "EpochDiagnostics",
        "FixedBucketBatchSizeConstraint", "IndexedCheckpointBackend", "ReplayCheckpointBackend",
        "RoundRobinSampler", "SamplingConstraint", "SamplingDiagnostics", "SimpleCutSampler",
        "StatelessSampler", "TimeConstraint", "TokenConstraint", "WeightedDataSource",
        "WeightedSimpleCutSampler", "ZipSampler", "estimate_duration_buckets",
        "find_pessimistic_batches", "report_padding_ratio_estimate"),
    "cut_transforms": (
        "ClippingTransform", "Compress", "CutConcatenate", "CutMix", "ExtraPadding",
        "LowpassUsingResampling", "PerturbSpeed", "PerturbTempo", "PerturbVolume",
        "ReverbWithImpulseResponse", "concat_cuts"),
    "collation": (
        "TokenCollater", "collate_audio", "collate_custom_field", "collate_features",
        "collate_images", "collate_matrices", "collate_multi_channel_audio", "collate_multi_channel_features",
        "collate_vectors"),
    "dataloading": (
        "WorkerInfo", "get_rank", "get_worker_info", "get_world_size", "make_worker_init_fn",
        "resolve_seed", "set_worker_info", "worker_init_fn"),
    "input_strategies": ("AudioSamples", "BatchIO", "OnTheFlyFeatures", "PrecomputedFeatures"),
    "signal_transforms": ("DereverbWPE", "GlobalMVN", "RandomizedSmoothing", "SpecAugment"),
    "audio_tagging": ("AudioTaggingDataset",),
    "device_augment": ("OnDeviceAugmenter",),
    "diarization": ("DiarizationDataset",),
    "iterable_dataset": ("IdentityDataset", "IterableDatasetWrapper"),
    "loader": ("DataLoader", "device_prefetch"),
    "vis": ("plot_batch",),
    "source_separation": (
        "DynamicallyMixedSourceSeparationDataset", "PreMixedSourceSeparationDataset",
        "SourceSeparationDataset"),
    "speech_recognition": ("K2SpeechRecognitionDataset", "validate_for_asr"),
    "speech_synthesis": ("SpeechSynthesisDataset", "validate_for_tts"),
    "speech_translation": ("K2Speech2TextTranslationDataset",),
    "surt": ("K2SurtDataset",),
    "unsupervised": (
        "DynamicUnsupervisedDataset", "RecordingChunkIterableDataset", "UnsupervisedDataset",
        "UnsupervisedWaveformDataset", "audio_chunk_collate", "audio_chunk_worker_init_fn"),
    "vad": ("VadDataset",),
    "webdataset": ("LazyWebdatasetIterator", "WebdatasetWriter", "export_to_webdataset"),
}
_NAME_TO_MODULE = {name: module for module, names in _MODULES.items() for name in names}

__all__ = sorted(_NAME_TO_MODULE)


def __getattr__(name: str):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _NAME_TO_MODULE:
        return getattr(importlib.import_module(f"{__name__}.{_NAME_TO_MODULE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__) | _SUBMODULES)
