from lhotse_tpu_torch.cut.base import Cut
from lhotse_tpu_torch.cut.data import DataCut
from lhotse_tpu_torch.cut.mixed import MixedCut, MixTrack
from lhotse_tpu_torch.cut.mono import MonoCut
from lhotse_tpu_torch.cut.multi import MultiCut
from lhotse_tpu_torch.cut.padding import PaddingCut
from lhotse_tpu_torch.cut.set import (
    CutSet, append, append_cuts, compute_supervisions_frame_mask, create_cut_set_eager,
    create_cut_set_lazy, deserialize_cut, mix, mix_cuts, pad)
from lhotse_tpu_torch.cut.text import TextExample, TextPairExample

# Register Cut/CutSet with the validator registry now that the classes exist
# (deferred in qa.py to avoid an import cycle).
from lhotse_tpu_torch.qa import _register_cut_validators as _rcv

_rcv()
del _rcv

__all__ = [
    "Cut", "CutSet", "DataCut", "MixTrack", "MixedCut", "MonoCut", "MultiCut", "PaddingCut",
    "TextExample", "TextPairExample", "append", "append_cuts", "compute_supervisions_frame_mask",
    "create_cut_set_eager", "create_cut_set_lazy", "deserialize_cut", "mix", "mix_cuts", "pad"]
