"""
Reverberation by convolution with a (possibly synthetic) room impulse
response (copied from ``lhotse_tpu/augmentation/rir.py``): Kaldi
wav-reverberate semantics with forced --shift-output (output length ==
input length, shifted by the RIR peak index), per-channel convolution,
energy normalization, optional early-reflections-only (first 50 ms), and the
FRA-RIR fast random generator when no RIR is given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from lhotse_tpu_torch.augmentation.transform import AudioTransform
from lhotse_tpu_torch.augmentation.utils import FastRandomRIRGenerator, convolve1d
from lhotse_tpu_torch.utils import Seconds

_EARLY_REFLECTIONS_SEC = 0.05


@dataclass
class ReverbWithImpulseResponse(AudioTransform):
    """
    Reverberation effect by convolving with a room impulse response; output
    length equals input length (shift-output semantics).
    """

    rir: Optional[dict] = None
    normalize_output: bool = True
    early_only: bool = False
    rir_channels: List[int] = field(default_factory=lambda: [0])
    rir_generator: Optional[Union[dict, Callable]] = None

    RIR_SCALING_FACTOR: float = 0.5**15

    def __post_init__(self):
        if isinstance(self.rir, dict):
            from lhotse_tpu_torch.serialization import deserialize_item

            payload = dict(self.rir)
            if "recording" in payload:
                payload["recording"] = dict(payload["recording"])
            self.rir = deserialize_item(payload)

        assert (
            self.rir is not None or self.rir_generator is not None
        ), "Either `rir` or `rir_generator` must be provided."

        if self.rir is not None:
            assert all(
                c < self.rir.num_channels for c in self.rir_channels
            ), "Invalid channel index in `rir_channels`"

        if isinstance(self.rir_generator, dict):
            self.rir_generator = FastRandomRIRGenerator(**self.rir_generator)

    @property
    def is_deterministic(self) -> bool:
        # The synthetic-RIR path draws a fresh room from a STATEFUL rng on
        # every call (even when seeded, successive calls differ), so only a
        # fixed RIR makes this transform memoizable.
        return self.rir is not None

    @property
    def channel_wise(self) -> bool:
        # Several RIR channels fan a mono input out, or pair RIR channel d
        # with input row d.
        return len(self.rir_channels) == 1

    def to_dict(self) -> dict:
        from lhotse_tpu_torch.audio import Recording
        from lhotse_tpu_torch.cut import Cut

        rir = self.rir
        if isinstance(rir, (Recording, Cut)):
            rir = rir.to_dict()
        gen = self.rir_generator
        if gen is not None and not isinstance(gen, dict):
            gen = gen.to_dict()
        return {
            "name": type(self).__name__,
            "kwargs": { "rir": rir, "normalize_output": self.normalize_output, "early_only": self.early_only, "rir_channels": list(self.rir_channels), "rir_generator": gen, },
        }

    def _impulse_response(self) -> np.ndarray:
        """The (channels, taps) RIR to convolve with — loaded or synthesized."""
        if self.rir is None:
            return self.rir_generator(nsource=1)
        from lhotse_tpu_torch.audio import Recording

        rir = self.rir.to_cut() if isinstance(self.rir, Recording) else self.rir
        rir = rir.with_channels(self.rir_channels)
        if self.early_only:
            rir = rir.truncate(duration=_EARLY_REFLECTIONS_SEC)
        return rir.load_audio()

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        D_in, N_in = samples.shape
        mono_in = D_in == 1

        if mono_in:
            assert (
                self.rir is not None or len(self.rir_channels) == 1
            ), "For mono input, either provide an RIR explicitly or set rir_channels to [0]."
        else:
            assert len(self.rir_channels) in (1, D_in), (
                "For multi-channel input, only mono RIRs or RIRs with the same "
                "number of channels as the input are supported."
            )

        rir = self._impulse_response()
        D_out = rir.shape[0] if mono_in else D_in
        if rir.shape[0] == 1:
            rir = np.repeat(rir, D_out, axis=0)

        out = np.zeros((D_out, N_in), dtype=samples.dtype)
        for d in range(D_out):
            dry = samples[0 if mono_in else d]
            out[d, :N_in] = dry
            taps = rir[d] * self.RIR_SCALING_FACTOR
            wet = convolve1d(dry, taps)
            # --shift-output semantics: align the RIR peak with t=0.
            peak = int(np.argmax(taps))
            wet = wet[peak : peak + N_in]
            out[d, : len(wet)] = wet
            if self.normalize_output:
                dry_power = np.sum(np.abs(dry) ** 2) / N_in
                wet_power = np.sum(np.abs(out[d]) ** 2) / N_in
                if wet_power > 0:
                    out[d] *= np.sqrt(dry_power / wet_power)
        return out

    def reverse_timestamps(
        self, offset: Seconds, duration: Optional[Seconds], sampling_rate: Optional[int],
    ) -> Tuple[Seconds, Optional[Seconds]]:
        # Shift-output preserves timing.
        return offset, duration
