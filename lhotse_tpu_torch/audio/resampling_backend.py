"""
The resampling backends the port has (the listing of
``lhotse_tpu/audio/resampling_backend.py``, for the CLI's
``list-resampling-backends``).

The port has one backend, ``"default"``, the built-in polyphase sinc
resampler. The JAX package also lists ``"sox"`` where libsox loads; the
port's libsox backend is not ported, and
:class:`~lhotse_tpu_torch.augmentation.transforms.Resample` refuses any
backend but ``"default"``.
"""
from __future__ import annotations

from typing import List


def available_resampling_backends() -> List[str]:
    return ["default"]
