from lhotse_tpu_torch.audio.backend import (
    AudioBackend, audio_backend, available_audio_backends, get_current_audio_backend,
    get_default_audio_backend, info, read_audio, read_sph, save_audio, set_current_audio_backend)
from lhotse_tpu_torch.audio.mixer import AudioMixer, audio_energy
from lhotse_tpu_torch.audio.recording import Recording
from lhotse_tpu_torch.audio.recording_set import RecordingSet
from lhotse_tpu_torch.audio.resampling_backend import (
    available_resampling_backends, get_current_resampling_backend, resampling_backend,
    set_current_resampling_backend)
from lhotse_tpu_torch.audio.source import AudioSource
from lhotse_tpu_torch.audio.utils import (
    AudioLoadingError, DurationMismatchError, VideoInfo, get_audio_duration_mismatch_tolerance,
    null_result_on_audio_loading_error, set_audio_duration_mismatch_tolerance,
    suppress_audio_loading_errors)

__all__ = [
    "AudioBackend", "AudioLoadingError", "AudioMixer", "AudioSource", "DurationMismatchError",
    "Recording", "RecordingSet", "VideoInfo", "audio_backend", "audio_energy",
    "available_audio_backends", "available_resampling_backends", "get_current_resampling_backend",
    "resampling_backend", "set_current_resampling_backend", "get_audio_duration_mismatch_tolerance",
    "get_current_audio_backend", "get_default_audio_backend", "info",
    "null_result_on_audio_loading_error", "read_audio", "read_sph", "save_audio",
    "set_audio_duration_mismatch_tolerance", "set_current_audio_backend",
    "suppress_audio_loading_errors"]
