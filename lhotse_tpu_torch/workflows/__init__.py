"""
The port's workflows (``lhotse_tpu/workflows``): meeting simulation. The
activity-detection workflow, and the Whisper, DNSMOS and forced-alignment
workflows (which need model weights), are not ported (see ROADMAP.md).
"""
from lhotse_tpu_torch.workflows.meeting_simulation import (
    BaseMeetingSimulator, ConversationalMeetingSimulator, MeetingSampler,
    SpeakerIndependentMeetingSimulator, reverberate_cuts)

__all__ = [
    "BaseMeetingSimulator", "ConversationalMeetingSimulator", "MeetingSampler",
    "SpeakerIndependentMeetingSimulator", "reverberate_cuts"]
