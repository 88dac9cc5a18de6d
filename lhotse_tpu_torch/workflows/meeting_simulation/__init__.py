from lhotse_tpu_torch.workflows.meeting_simulation.base import (
    BaseMeetingSimulator, MeetingSampler, reverberate_cuts)
from lhotse_tpu_torch.workflows.meeting_simulation.conversational import (
    ConversationalMeetingSimulator,)
from lhotse_tpu_torch.workflows.meeting_simulation.speaker_independent import (
    SpeakerIndependentMeetingSimulator,
)

__all__ = [
    "BaseMeetingSimulator", "ConversationalMeetingSimulator", "MeetingSampler",
    "SpeakerIndependentMeetingSimulator", "reverberate_cuts"]
