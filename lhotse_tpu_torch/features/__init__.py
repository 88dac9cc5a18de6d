"""Feature extraction and storage of the PyTorch port (port of ``lhotse_tpu/features``).

Importing the package registers every extractor under the JAX package's
names: the Kaldi extractors (``kaldi-fbank``, ``kaldi-mfcc``,
``kaldi-spectrogram``, ``kaldi-log-spectrogram``) and those under the
reference's names (``fbank``, ``mfcc``, ``spectrogram``, ``kaldifeat-fbank``,
``kaldifeat-mfcc``, ``whisper-fbank``, ``librosa-fbank``), so a stored
``Features.type`` of any of them resolves, and mixes, here. Every storage
backend of the JAX package is here (:mod:`lhotse_tpu_torch.features.io`).
The extractors that wrap an outside package (openSMILE, S3PRL) are not
ported.
"""
from lhotse_tpu_torch.features.base import (
    FeatureExtractor, Features, FeatureSet, FeatureSetBuilder, StatsAccumulator,
    compute_global_stats, create_default_feature_extractor, get_extractor_type,
    register_extractor, store_feature_array)
from lhotse_tpu_torch.features.compliance import (
    TorchaudioFbank, TorchaudioFbankConfig, TorchaudioMfcc, TorchaudioMfccConfig,
    TorchaudioSpectrogram, TorchaudioSpectrogramConfig)
from lhotse_tpu_torch.features.io import (
    ChunkedLilcomHdf5Reader, ChunkedLilcomHdf5Writer, FeaturesReader, FeaturesWriter,
    KaldiReader, KaldiWriter, LilcomChunkyReader, LilcomChunkyWriter, LilcomFilesReader,
    LilcomFilesWriter, LilcomHdf5Reader, LilcomHdf5Writer, LilcomURLReader, LilcomURLWriter,
    MemoryLilcomReader, MemoryLilcomWriter, MemoryRawReader, MemoryRawWriter, NumpyFilesReader,
    NumpyFilesWriter, NumpyHdf5Reader, NumpyHdf5Writer, StorageBackendInfo,
    available_storage_backends, close_cached_file_handles, default_features_storage_backend,
    get_memory_writer, get_reader, get_writer, storage_backend_statuses)
from lhotse_tpu_torch.features.kaldi.extractors import (
    Fbank, FbankConfig, LogSpectrogram, LogSpectrogramConfig, Mfcc, MfccConfig, Spectrogram,
    SpectrogramConfig)
from lhotse_tpu_torch.features.kaldifeat import (
    KaldifeatFbank, KaldifeatFbankConfig, KaldifeatFrameOptions, KaldifeatMelOptions, KaldifeatMfcc,
    KaldifeatMfccConfig)
from lhotse_tpu_torch.features.librosa_fbank import LibrosaFbank, LibrosaFbankConfig
from lhotse_tpu_torch.features.mixer import FeatureMixer
from lhotse_tpu_torch.features.whisper import WhisperFbank, WhisperFbankConfig

__all__ = [
    "ChunkedLilcomHdf5Reader", "ChunkedLilcomHdf5Writer", "Fbank", "FbankConfig",
    "FeatureExtractor", "FeatureMixer", "FeatureSet", "FeatureSetBuilder", "Features",
    "FeaturesReader", "FeaturesWriter", "KaldiReader", "KaldiWriter", "KaldifeatFbank",
    "KaldifeatFbankConfig", "KaldifeatFrameOptions", "KaldifeatMelOptions", "KaldifeatMfcc",
    "KaldifeatMfccConfig", "LibrosaFbank", "LibrosaFbankConfig", "LilcomChunkyReader",
    "LilcomChunkyWriter", "LilcomFilesReader", "LilcomFilesWriter", "LilcomHdf5Reader",
    "LilcomHdf5Writer", "LilcomURLReader", "LilcomURLWriter", "LogSpectrogram",
    "LogSpectrogramConfig", "MemoryLilcomReader", "MemoryLilcomWriter", "MemoryRawReader",
    "MemoryRawWriter", "Mfcc", "MfccConfig", "NumpyFilesReader", "NumpyFilesWriter",
    "NumpyHdf5Reader", "NumpyHdf5Writer", "Spectrogram", "SpectrogramConfig",
    "StatsAccumulator", "StorageBackendInfo", "TorchaudioFbank", "TorchaudioFbankConfig",
    "TorchaudioMfcc", "TorchaudioMfccConfig", "TorchaudioSpectrogram",
    "TorchaudioSpectrogramConfig", "WhisperFbank", "WhisperFbankConfig",
    "available_storage_backends", "close_cached_file_handles", "compute_global_stats",
    "create_default_feature_extractor", "default_features_storage_backend",
    "get_extractor_type", "get_memory_writer", "get_reader", "get_writer",
    "register_extractor", "storage_backend_statuses", "store_feature_array"]
