"""
The port's workflows (``lhotse_tpu/workflows``): activity detection (the
energy VAD on the host, Silero through ``torch.hub``) and meeting
simulation. The Whisper, DNSMOS and forced-alignment workflows, which need
model weights, are not ported (see ROADMAP.md).
"""
from lhotse_tpu_torch.workflows.activity_detection import (
    Activity, ActivityDetector, EnergyVAD, SileroVAD, SileroVAD8k, SileroVAD16k,
    detect_activity_energy, detect_activity_energy_single)
from lhotse_tpu_torch.workflows.meeting_simulation import (
    BaseMeetingSimulator, ConversationalMeetingSimulator, MeetingSampler,
    SpeakerIndependentMeetingSimulator, reverberate_cuts)

__all__ = [
    "Activity", "ActivityDetector", "BaseMeetingSimulator", "ConversationalMeetingSimulator",
    "EnergyVAD", "MeetingSampler", "SileroVAD", "SileroVAD8k", "SileroVAD16k",
    "SpeakerIndependentMeetingSimulator", "detect_activity_energy",
    "detect_activity_energy_single", "reverberate_cuts"]
