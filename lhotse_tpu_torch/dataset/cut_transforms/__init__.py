"""
Cut transforms of the PyTorch port (copied from
``lhotse_tpu/dataset/cut_transforms``): CutSet -> CutSet callables for
``K2SpeechRecognitionDataset(cut_transforms=...)``, each with
``state_dict``/``load_state_dict`` of its random state in the JAX
package's format.
"""
from lhotse_tpu_torch.dataset.cut_transforms.clipping import ClippingTransform
from lhotse_tpu_torch.dataset.cut_transforms.compress import Compress
from lhotse_tpu_torch.dataset.cut_transforms.concatenate import CutConcatenate, concat_cuts
from lhotse_tpu_torch.dataset.cut_transforms.extra_padding import ExtraPadding
from lhotse_tpu_torch.dataset.cut_transforms.lowpass import LowpassUsingResampling
from lhotse_tpu_torch.dataset.cut_transforms.mix import CutMix
from lhotse_tpu_torch.dataset.cut_transforms.perturb_speed import PerturbSpeed
from lhotse_tpu_torch.dataset.cut_transforms.perturb_tempo import PerturbTempo
from lhotse_tpu_torch.dataset.cut_transforms.perturb_volume import PerturbVolume
from lhotse_tpu_torch.dataset.cut_transforms.reverberate import ReverbWithImpulseResponse

__all__ = [
    "ClippingTransform", "Compress", "CutConcatenate", "CutMix", "ExtraPadding",
    "LowpassUsingResampling", "PerturbSpeed", "PerturbTempo", "PerturbVolume",
    "ReverbWithImpulseResponse", "concat_cuts"]
