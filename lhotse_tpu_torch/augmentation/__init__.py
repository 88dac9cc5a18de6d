"""
Host audio augmentation of the PyTorch port (copied from
``lhotse_tpu/augmentation``): the lazily applied ``Recording`` transforms
``Speed``, ``Resample``, ``Tempo``, ``Volume``,
``ReverbWithImpulseResponse``, ``DereverbWPE`` (host numpy WPE),
``Clipping``, ``LoudnessNormalization``, ``Narrowband`` and the
``Compress`` codec round trip, the sinc resampler and the FRA-RIR
generator.
"""
from lhotse_tpu_torch.augmentation.clipping import Clipping
from lhotse_tpu_torch.augmentation.compress import Compress
from lhotse_tpu_torch.augmentation.loudness import LoudnessNormalization, normalize_loudness
from lhotse_tpu_torch.augmentation.narrowband import Narrowband
from lhotse_tpu_torch.augmentation.resample import (
    SincResampler, get_or_create_resampler, resample_array)
from lhotse_tpu_torch.augmentation.rir import ReverbWithImpulseResponse
from lhotse_tpu_torch.augmentation.transform import AudioTransform
from lhotse_tpu_torch.augmentation.transforms import (Resample, Speed, Tempo, Volume, wsola_time_stretch)
from lhotse_tpu_torch.augmentation.utils import (
    AugmentFn, FastRandomRIRGenerator, convolve1d, next_fast_len)
from lhotse_tpu_torch.augmentation.wpe import DereverbWPE, dereverb_wpe_numpy, dereverb_wpe_torch

__all__ = [
    "AudioTransform", "AugmentFn", "Clipping", "Compress", "DereverbWPE", "FastRandomRIRGenerator",
    "LoudnessNormalization", "Narrowband", "Resample", "ReverbWithImpulseResponse",
    "SincResampler", "Speed", "Tempo", "Volume", "convolve1d", "dereverb_wpe_numpy",
    "get_or_create_resampler", "next_fast_len", "normalize_loudness", "resample_array",
    "wsola_time_stretch"]
