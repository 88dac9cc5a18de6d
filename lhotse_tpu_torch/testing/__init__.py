"""Test factories of the PyTorch port (copied from ``lhotse_tpu/testing``)."""
from lhotse_tpu_torch.testing.dummies import (
    DummyManifest, as_lazy, dummy_alignment, dummy_array, dummy_audio_source, dummy_cut,
    dummy_features, dummy_in_memory_features, dummy_multi_channel_features,
    dummy_multi_channel_recording, dummy_multi_cut, dummy_recording, dummy_supervision,
    dummy_temporal_array, dummy_temporal_array_uint8, remove_spaces_from_segment_text)

__all__ = [
    "DummyManifest", "as_lazy", "dummy_alignment", "dummy_array", "dummy_audio_source",
    "dummy_cut", "dummy_features", "dummy_in_memory_features", "dummy_multi_channel_features",
    "dummy_multi_channel_recording", "dummy_multi_cut", "dummy_recording", "dummy_supervision",
    "dummy_temporal_array", "dummy_temporal_array_uint8", "remove_spaces_from_segment_text"]
