"""
Silero VAD (copied from
``lhotse_tpu/workflows/activity_detection/silero_vad.py``): the model is
loaded through ``torch.hub`` on the detector's device (the card unless the
caller asks for the CPU), so this detector only works where the snakers4
silero-vad checkpoint is in the hub's cache or can be fetched.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from lhotse_tpu_torch.utils import is_module_available
from lhotse_tpu_torch.workflows.activity_detection.base import Activity, ActivityDetector


class SileroVAD(ActivityDetector):
    """Silero voice-activity model at 16 kHz."""

    def __init__(
        self, device: str = "cuda", sampling_rate: int = 16_000,
        force_download: bool = False):
        if sampling_rate not in (8_000, 16_000):
            raise ValueError(
                f"Sampling rate must be either 8000 or 16000, but got {sampling_rate}")
        super().__init__(
            detector_name=f"silero_vad_{sampling_rate // 1000}k",
            sampling_rate=sampling_rate, device=device)
        assert is_module_available("torch"), "SileroVAD requires torch."
        self._model, self._get_speech_timestamps = self._get_model(
            device=device, force_download=force_download)

    @classmethod
    def _get_model(cls, device: str = "cuda", force_download: bool = False):
        import torch

        model, utils = torch.hub.load(
            repo_or_dir="snakers4/silero-vad", model="silero_vad", force_reload=force_download,
            onnx=False)
        get_speech_timestamps = utils[0]
        return model.to(device), get_speech_timestamps

    def forward(self, track: np.ndarray) -> List[Activity]:
        import torch

        wav = torch.from_numpy(np.ascontiguousarray(track, dtype=np.float32))
        spans: List[Dict[str, float]] = self._get_speech_timestamps(
            wav.to(self._device), self._model, sampling_rate=self._sampling_rate,
            return_seconds=False)
        sr = float(self._sampling_rate)
        return [
            Activity(
                start=span["start"] / sr,
                duration=(span["end"] - span["start"]) / sr,
            )
            for span in spans
        ]

    @classmethod
    def force_download(cls):
        cls._get_model(device="cpu", force_download=True)


class SileroVAD16k(SileroVAD):
    """The explicit 16 kHz alias."""

    pass


class SileroVAD8k(SileroVAD):
    """The same model driven at 8 kHz."""

    def __init__(self, device: str = "cuda", force_download: bool = False):
        SileroVAD.__init__(
            self, device=device, sampling_rate=8_000, force_download=force_download)
