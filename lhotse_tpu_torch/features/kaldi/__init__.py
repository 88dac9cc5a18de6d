"""Kaldi-compatible feature extractors and layers (port of ``lhotse_tpu/features/kaldi``)."""
from lhotse_tpu_torch.features.kaldi.extractors import (
    Fbank, FbankConfig, LogSpectrogram, LogSpectrogramConfig, Mfcc, MfccConfig, Spectrogram,
    SpectrogramConfig)
from lhotse_tpu_torch.features.kaldi.layers import (
    Wav2FFT, Wav2LogFilterBank, Wav2LogSpec, Wav2MFCC, Wav2Spec, Wav2Win)
