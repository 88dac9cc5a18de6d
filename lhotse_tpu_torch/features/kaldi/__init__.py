"""Kaldi-compatible feature layers (port of ``lhotse_tpu/features/kaldi``)."""
from lhotse_tpu_torch.features.kaldi.layers import (
    Wav2FFT, Wav2LogFilterBank, Wav2LogSpec, Wav2MFCC, Wav2Spec, Wav2Win)
