from lhotse_tpu_torch.workflows.activity_detection.base import Activity, ActivityDetector
from lhotse_tpu_torch.workflows.activity_detection.energy import (
    detect_activity_energy, detect_activity_energy_single)
from lhotse_tpu_torch.workflows.activity_detection.energy_vad import EnergyVAD
from lhotse_tpu_torch.workflows.activity_detection.silero_vad import (
    SileroVAD, SileroVAD8k, SileroVAD16k)

__all__ = [
    "Activity", "ActivityDetector", "EnergyVAD", "SileroVAD", "SileroVAD8k", "SileroVAD16k",
    "detect_activity_energy", "detect_activity_energy_single"]
