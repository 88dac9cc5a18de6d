"""Feature extraction and storage of the PyTorch port (port of ``lhotse_tpu/features``)."""
from lhotse_tpu_torch.features.base import (
    FeatureExtractor, Features, FeatureSet, FeatureSetBuilder, compute_global_stats,
    create_default_feature_extractor, get_extractor_type, register_extractor,
    store_feature_array)
from lhotse_tpu_torch.features.io import (
    FeaturesReader, FeaturesWriter, LilcomChunkyReader, LilcomChunkyWriter, LilcomFilesReader,
    LilcomFilesWriter, NumpyFilesReader, NumpyFilesWriter, available_storage_backends,
    close_cached_file_handles, default_features_storage_backend, get_reader, get_writer)
from lhotse_tpu_torch.features.kaldi.extractors import (
    Fbank, FbankConfig, LogSpectrogram, LogSpectrogramConfig, Mfcc, MfccConfig, Spectrogram,
    SpectrogramConfig)

__all__ = [
    "FeatureExtractor", "Features", "FeatureSet", "FeatureSetBuilder", "FeaturesReader",
    "FeaturesWriter", "Fbank", "FbankConfig", "LilcomChunkyReader", "LilcomChunkyWriter",
    "LilcomFilesReader", "LilcomFilesWriter", "LogSpectrogram", "LogSpectrogramConfig", "Mfcc",
    "MfccConfig", "NumpyFilesReader", "NumpyFilesWriter", "Spectrogram", "SpectrogramConfig",
    "available_storage_backends", "close_cached_file_handles", "compute_global_stats",
    "create_default_feature_extractor", "default_features_storage_backend", "get_extractor_type",
    "get_reader", "get_writer", "register_extractor", "store_feature_array"]
