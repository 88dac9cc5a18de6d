"""
Cut transforms of the PyTorch port (copied from
``lhotse_tpu/dataset/cut_transforms``): CutSet -> CutSet callables for
``K2SpeechRecognitionDataset(cut_transforms=...)``, each with
``state_dict``/``load_state_dict`` of its random state in the JAX
package's format. ``CutConcatenate``, ``ClippingTransform``, ``Compress``
and ``LowpassUsingResampling`` are not ported: building one raises
``NotImplementedError``.
"""
from lhotse_tpu_torch.dataset.cut_transforms.extra_padding import ExtraPadding
from lhotse_tpu_torch.dataset.cut_transforms.mix import CutMix
from lhotse_tpu_torch.dataset.cut_transforms.perturb_speed import PerturbSpeed
from lhotse_tpu_torch.dataset.cut_transforms.perturb_tempo import PerturbTempo
from lhotse_tpu_torch.dataset.cut_transforms.perturb_volume import PerturbVolume
from lhotse_tpu_torch.dataset.cut_transforms.reverberate import ReverbWithImpulseResponse
from lhotse_tpu_torch.utils import not_ported


def _left_out(name: str) -> type:
    def __init__(self, *args, **kwargs):
        raise not_ported(f"The {name} cut transform")

    return type(name, (), {"__init__": __init__})


ClippingTransform = _left_out("ClippingTransform")
Compress = _left_out("Compress")
CutConcatenate = _left_out("CutConcatenate")
LowpassUsingResampling = _left_out("LowpassUsingResampling")

__all__ = [
    "ClippingTransform", "Compress", "CutConcatenate", "CutMix", "ExtraPadding",
    "LowpassUsingResampling", "PerturbSpeed", "PerturbTempo", "PerturbVolume",
    "ReverbWithImpulseResponse"]
