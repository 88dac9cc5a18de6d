"""
PyTorch/CUDA port of :mod:`lhotse_tpu`: the host data path and the on-device
augment→fbank→encoder path.

The module paths and public names mirror the JAX package, so
``lhotse_tpu/ops/augment.py`` has its counterpart in
``lhotse_tpu_torch/ops/augment.py``, and each package exports the names its
JAX counterpart exports, as far as they are ported: ``from lhotse_tpu_torch
import CutSet, Fbank, load_manifest`` works as ``from lhotse_tpu import
...`` does. This package resolves its names at first use, so importing one
submodule (the kernel's, say) does not import the whole host layer. The
port imports ``torch`` and numpy only: never ``jax`` and never
``lhotse_tpu``. The host data layer it needs
(manifests, NIST SPHERE/WAV/FLAC/AIFF audio, ``CutSet``, ``DynamicBucketingSampler``,
``K2SpeechRecognitionDataset`` with ``AudioSamples``, ``DataLoader``, the
stored features, the host augmentation: recording transforms,
``PaddingCut``/``MixedCut`` and the cut transforms, Shar, and the recipe
path: ``RecordingSet``/``SupervisionSet``, ``CutSet.from_manifests``, the
trimming and windowing, ``SimpleCutSampler``/``BucketingSampler`` and the
LibriSpeech recipe, the multi-channel meeting path: ``MultiCut``, the
host ``DereverbWPE`` transform and the AMI recipe, and the extractors under
the reference's names: ``fbank``, ``mfcc``, ``spectrogram``, the kaldifeat,
Whisper and librosa fbanks, and the paired and remaining task datasets:
``CutPairsSampler``, speech translation, source separation, TTS with
``TokenCollater``, audio tagging and the unsupervised datasets, Kaldi
data dirs with piped ``command`` audio sources, the recipes, and the
multiplexers ``CutSet.mux``/``infinite_mux`` with ``DataloaderCheckpoint``,
the batch signal transforms and text sampling, and the storage and I/O
backends: tar members and URLs in ``open_best``, the AIS batch loader, the
HDF5, Kaldi and ``lilcom_url`` feature stores, cut audio I/O
(``save_audios``, ``copy_data``, ``prefetch``), ``attach_tensor``, image
manifests, the energy and Silero VAD workflow, the sox resampler, the
HuggingFace bridges and the plots) is copied function by
function from the JAX package's modules of the same
paths; a copied body that reaches a part not copied yet raises
``NotImplementedError``. The tests hold each copy to its original.

The command line, ``lhotse-tpu-torch`` (``python -m
lhotse_tpu_torch.bin.lhotse_tpu_torch``), mirrors the JAX package's over
the ported paths; it alone needs click.

The one hand-written kernel is the fused log-mel fbank
(:mod:`lhotse_tpu_torch.ops.fbank_cuda`, CUDA C++ in ``csrc/fbank.cu``),
built with ``nvcc`` at first use. A CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.

Data-parallel training runs one process per rank joined by
``torch.distributed``; the encoder's tensor-parallel placement is
``models.encoder.param_shardings`` over a ("data", "model")
``DeviceMesh``, and ``entry.dryrun_multichip(n)`` checks the whole
multi-rank step over ``n`` spawned gloo ranks on the CPU.
"""

_EXPORTS = {
    "array": ("Array", "TemporalArray", "deserialize_array", "pad_array"),
    "audio": (
        "AudioSource", "Recording", "RecordingSet", "audio_backend", "available_audio_backends",
        "available_resampling_backends", "get_audio_duration_mismatch_tolerance",
        "get_current_audio_backend", "get_current_resampling_backend", "get_default_audio_backend",
        "get_ffmpeg_torchaudio_info_enabled", "resampling_backend", "set_audio_duration_mismatch_tolerance", "set_current_audio_backend",
        "set_current_resampling_backend", "set_ffmpeg_torchaudio_info_enabled"),
    "caching": ("is_caching_enabled", "set_caching_enabled"),
    "cut": (
        "CutSet", "MixedCut", "MonoCut", "MultiCut", "PaddingCut", "create_cut_set_eager",
        "create_cut_set_lazy"),
    "features": (
        "FeatureExtractor", "FeatureSet", "FeatureSetBuilder", "Features", "Fbank", "FbankConfig",
        "KaldifeatFbank", "KaldifeatFbankConfig", "KaldifeatMfcc", "KaldifeatMfccConfig",
        "LibrosaFbank", "LibrosaFbankConfig", "LilcomChunkyWriter", "LilcomFilesWriter",
        "LilcomHdf5Writer", "ChunkedLilcomHdf5Writer", "NumpyHdf5Writer",
        "LogSpectrogram", "LogSpectrogramConfig", "Mfcc", "MfccConfig", "NumpyFilesWriter",
        "Spectrogram", "SpectrogramConfig", "TorchaudioFbank", "TorchaudioFbankConfig",
        "TorchaudioMfcc", "TorchaudioMfccConfig", "TorchaudioSpectrogram",
        "TorchaudioSpectrogramConfig", "WhisperFbank", "WhisperFbankConfig",
        "available_storage_backends", "create_default_feature_extractor"),
    "image": ("Image",),
    "kaldi": ("load_kaldi_data_dir",),
    "lazy": ("dill_enabled", "is_dill_enabled", "set_dill_enabled"),
    "manipulation": ("combine", "split_parallelize_combine", "to_manifest"),
    "qa": ("fix_manifests", "validate", "validate_recordings_and_supervisions"),
    "serialization": (
        "available_io_backends", "get_current_io_backend", "get_default_io_backend",
        "io_backend", "load_manifest", "load_manifest_lazy", "load_manifest_lazy_or_eager",
        "set_current_io_backend", "store_manifest"),
    "supervision": ("AlignmentItem", "SupervisionSegment", "SupervisionSet"),
    "tools.env": ("default_tools_cachedir",),
    "tracing": (
        "emit_metrics", "format_tracing_report", "is_tracing_enabled", "register_metrics_hook",
        "set_tracing_enabled", "trace_span", "tracing_report", "unregister_metrics_hook"),
    "utils": (
        "Decibels", "Seconds", "add_durations", "compute_num_frames", "compute_num_samples",
        "fastcopy", "fix_random_seed", "measure_overlap", "streaming_shuffle"),
}
_NAME_TO_MODULE = {name: module for module, names in _EXPORTS.items() for name in names}
_SUBPACKAGES = frozenset(("ais", "dataset", "recipes"))

__all__ = sorted(_NAME_TO_MODULE)


def __getattr__(name: str):
    import importlib

    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _NAME_TO_MODULE:
        return getattr(importlib.import_module(f"{__name__}.{_NAME_TO_MODULE[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__) | _SUBPACKAGES)
