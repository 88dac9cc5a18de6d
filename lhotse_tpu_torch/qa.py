"""
Manifest validation (copied from ``lhotse_tpu/qa.py``): the type-dispatched
``validate`` for recordings, supervisions, cuts and CutSets, which
``validate_for_asr`` calls. ``fix_manifests`` and the Set validators are
not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from lhotse_tpu_torch.audio import Recording, get_audio_duration_mismatch_tolerance
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import is_equal_or_contains, not_ported

_VALIDATORS: Dict[Any, Callable] = {}


def validate(obj: Any, read_data: bool = False) -> None:
    """
    Validate a manifest object: positive durations, matching channels/ids,
    etc.; raises AssertionError on mismatch. With ``read_data=True``, also
    loads the audio/features and checks the declared sample/frame counts.
    """
    if not isinstance(read_data, bool):
        # validate(recordings, supervisions) would otherwise silently bind
        # the second manifest to read_data and validate only the first.
        raise TypeError(
            "validate() checks ONE manifest (second arg is the read_data "
            "flag). To cross-check a (recordings, supervisions) pair, use "
            "validate_recordings_and_supervisions(recordings, supervisions)."
        )
    validator = None
    for registered_type in _VALIDATORS:
        if isinstance(obj, registered_type):
            validator = _VALIDATORS[registered_type]
            break
    if validator is None:
        raise ValueError(
            f"Object of unknown type passed to validate() "
            f"(T = {type(obj)}, known types = {list(_VALIDATORS)})"
        )
    validator(obj, read_data=read_data)


def register_validator(fn):
    """Register a function invoked by ``validate()`` when the first arg's
    annotated type matches."""
    import typing

    # get_type_hints resolves PEP 563 string annotations into real types.
    hints = typing.get_type_hints(fn)
    first_arg_type = next(iter(hints.values()))
    _VALIDATORS[first_arg_type] = fn
    return fn


@register_validator
def validate_recording(r: Recording, read_data: bool = False) -> None:
    assert r.duration > 0, (
        f"Recording {r.id}: duration has to be greater than 0 (is {r.duration})"
    )
    expected_duration = r.num_samples / r.sampling_rate
    assert r.num_channels > 0, f"Recording {r.id}: no channels available"
    assert abs(expected_duration - r.duration) <= get_audio_duration_mismatch_tolerance(), (
        f"Recording {r.id}: mismatched declared duration ({r.duration}) with "
        f"num_samples / sampling_rate ({expected_duration})."
    )
    if read_data:
        samples = r.load_audio()
        n_ch, n_s = samples.shape
        assert r.num_channels == n_ch, (
            f"Recording {r.id}: expected {r.num_channels} channels, got {n_ch}"
        )
        assert r.num_samples == n_s, (
            f"Recording {r.id}: expected {r.num_samples} samples, got {n_s}"
        )


@register_validator
def validate_supervision(s: SupervisionSegment, read_data: bool = False, **kwargs) -> None:
    assert s.duration > 0, (
        f"Supervision {s.id}: duration has to be greater than 0 (is {s.duration})"
    )
    if s.custom is not None:
        assert isinstance(s.custom, dict), (
            f"SupervisionSegment {s.id}: custom field has to be a dict or None."
        )


def validate_cut(c, read_data: bool = False) -> None:
    from lhotse_tpu_torch.cut import MonoCut

    if not isinstance(c, MonoCut):
        raise not_ported(f"Validating {type(c).__name__}")

    assert c.start >= 0, f"Cut {c.id}: start must be 0 or greater (got {c.start})"
    assert c.duration > 0, f"Cut {c.id}: duration must be greater than 0 (got {c.duration})"
    assert c.sampling_rate > 0, (
        f"Cut {c.id}: sampling_rate must be greater than 0 (got {c.sampling_rate})"
    )
    assert c.has_features or c.has_recording, (
        f"Cut {c.id}: must have either Features or Recording attached."
    )

    if c.has_features:
        raise not_ported(f"Features manifests (cut {c.id!r})")

    if c.has_recording:
        validate_recording(c.recording)
        assert is_equal_or_contains(c.recording.channel_ids, c.channel)
        if read_data:
            samples = c.load_audio()
            assert c.num_samples == samples.shape[1], (
                f"Cut {c.id}: expected {c.num_samples} samples, got {samples.shape[1]}"
            )

    if isinstance(c, MonoCut):
        for s in c.supervisions:
            validate_supervision(s)
            assert s.recording_id == c.recording_id, (
                f"Cut {c.id}: supervision {s.id} has a mismatched recording_id "
                f"(expected {c.recording_id}, supervision has {s.recording_id})"
            )
            assert is_equal_or_contains(s.channel, c.channel) and is_equal_or_contains(
                c.channel, s.channel), (
                f"Cut {c.id}: supervision {s.id} has a mismatched channel "
                f"(expected {c.channel}, supervision has {s.channel})"
            )

    if c.custom is not None:
        assert isinstance(c.custom, dict), (f"Cut {c.id}: custom field has to be a dict or None.")


def _register_cut_validators():
    """Deferred registration for cut types to avoid import cycles."""
    from lhotse_tpu_torch.cut import Cut, CutSet

    def _validate_cut(c: Cut, read_data: bool = False) -> None:
        validate_cut(c, read_data=read_data)

    def _validate_cut_set(cuts: CutSet, read_data: bool = False) -> None:
        for c in cuts:
            validate_cut(c, read_data=read_data)

    _VALIDATORS[Cut] = _validate_cut
    _VALIDATORS[CutSet] = _validate_cut_set
