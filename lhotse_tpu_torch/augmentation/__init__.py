"""
Host audio augmentation of the PyTorch port (copied from
``lhotse_tpu/augmentation``): the lazily applied ``Recording`` transforms
``Speed``, ``Resample``, ``Tempo``, ``Volume`` and
``ReverbWithImpulseResponse`` and ``DereverbWPE`` (host numpy WPE), the
sinc resampler and the FRA-RIR generator. Clipping, codecs, narrowband and
loudness transforms are not ported.
"""
from lhotse_tpu_torch.augmentation.resample import (
    SincResampler, get_or_create_resampler, resample_array)
from lhotse_tpu_torch.augmentation.rir import ReverbWithImpulseResponse
from lhotse_tpu_torch.augmentation.transform import AudioTransform
from lhotse_tpu_torch.augmentation.transforms import (Resample, Speed, Tempo, Volume, wsola_time_stretch)
from lhotse_tpu_torch.augmentation.utils import (
    AugmentFn, FastRandomRIRGenerator, convolve1d, next_fast_len)
from lhotse_tpu_torch.augmentation.wpe import DereverbWPE, dereverb_wpe_numpy

__all__ = [
    "AudioTransform", "AugmentFn", "DereverbWPE", "FastRandomRIRGenerator", "Resample",
    "ReverbWithImpulseResponse", "SincResampler", "Speed", "Tempo", "Volume", "convolve1d",
    "dereverb_wpe_numpy", "get_or_create_resampler", "next_fast_len", "resample_array",
    "wsola_time_stretch"]
