"""
Manifest validation and fixing, conceptually Kaldi's ``utils/fix_data_dir.sh``
(copied from ``lhotse_tpu/qa.py``): the type-dispatched ``validate`` for
recordings, supervisions, features, arrays, cuts and their Sets, the pairwise
``validate_recordings_and_supervisions``, and ``fix_manifests`` (drop
recordings and supervisions without a counterpart, drop supervisions that
start past their recording's end and trim those that run past it).
``validate_shar`` checks a Shar directory's shard counts, cut/tar id
alignment and index sidecars.
"""
from __future__ import annotations

import logging
from collections import Counter, defaultdict
from math import isclose
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np

from lhotse_tpu_torch.array import Array, TemporalArray
from lhotse_tpu_torch.audio import (Recording, RecordingSet, get_audio_duration_mismatch_tolerance)
from lhotse_tpu_torch.features.base import Features, FeatureSet
from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
from lhotse_tpu_torch.utils import compute_num_frames, is_equal_or_contains, overlaps

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


def fix_manifests(
    recordings: RecordingSet, supervisions: SupervisionSet) -> Tuple[RecordingSet, SupervisionSet]:
    """
    Remove supervisions/recordings without counterparts, drop supervisions
    starting past the recording end, and trim those exceeding it.
    """
    recordings, supervisions = remove_missing_recordings_and_supervisions(recordings, supervisions)
    assert (
        len(frozenset(r.id for r in recordings)) > 0
    ), "No recordings left after fixing the manifests."
    supervisions = trim_supervisions_to_recordings(recordings, supervisions)
    assert (
        len(frozenset(s.id for s in supervisions)) > 0
    ), "No supervisions left after fixing the manifests."
    return recordings, supervisions


def validate_recordings_and_supervisions(
    recordings: Union[RecordingSet, Recording],
    supervisions: Union[SupervisionSet, SupervisionSegment], read_data: bool = False) -> None:
    """
    Validate both manifests and their mutual consistency; missing
    counterparts produce warnings (they get discarded when creating CutSets).
    """
    if isinstance(recordings, Recording):
        recordings = RecordingSet([recordings])
    if isinstance(supervisions, SupervisionSegment):
        supervisions = SupervisionSet([supervisions])
    recordings = recordings.to_eager()
    supervisions = supervisions.to_eager()
    validate(recordings, read_data=read_data)
    validate(supervisions)
    id2rec = {r.id: r for r in recordings}
    for s in supervisions:
        r = id2rec.get(s.recording_id)
        assert r is not None, (
            f"Supervision {s.id} references non-existent recording {s.recording_id}"
        )
        assert -1e-3 <= s.start <= s.end <= r.duration + 1e-3, (
            f"Supervision {s.id}: exceeded the bounds of its corresponding recording "
            f"(supervision spans [{s.start}, {s.end}]; recording spans [0, {r.duration}])"
        )
        assert is_equal_or_contains(r.channel_ids, s.channel), (
            f"Supervision {s.id}: channel {s.channel} does not exist in its "
            f"corresponding Recording (recording channels: {r.channel_ids})"
        )
    recording_ids = id2rec.keys()
    recording_ids_in_sups = frozenset(s.recording_id for s in supervisions)
    only_in_recordings = recording_ids - recording_ids_in_sups
    if only_in_recordings:
        logging.warning(
            f"There are {len(only_in_recordings)} recordings without any "
            f"corresponding supervisions in the SupervisionSet."
        )
    only_in_supervisions = recording_ids_in_sups - recording_ids
    if only_in_supervisions:
        logging.warning(
            f"There are {len(only_in_supervisions)} supervisions missing their "
            f"corresponding recordings in the RecordingSet."
        )


def remove_missing_recordings_and_supervisions(
    recordings: RecordingSet, supervisions: SupervisionSet) -> Tuple[RecordingSet, SupervisionSet]:
    """Drop entries that miss their counterparts (returns new manifests)."""
    recording_ids = frozenset(r.id for r in recordings)
    recording_ids_in_sups = frozenset(s.recording_id for s in supervisions)
    only_in_recordings = recording_ids - recording_ids_in_sups
    if only_in_recordings:
        recordings = recordings.filter(lambda r: r.id not in only_in_recordings)
        logging.warning(
            f"Removed {len(only_in_recordings)} recordings with no corresponding supervisions."
        )
    only_in_supervisions = recording_ids_in_sups - recording_ids
    if only_in_supervisions:
        supervision_ids = frozenset(s.id for s in supervisions)
        supervisions = supervisions.filter(lambda s: s.recording_id not in only_in_supervisions)
        supervision_ids_after = frozenset(s.id for s in supervisions)
        n_removed = len(supervision_ids) - len(supervision_ids_after)
        logging.warning(
            f"Removed {n_removed} supervisions with no corresponding recordings "
            f"(for a total of {len(only_in_supervisions)} recording IDs)."
        )
    return recordings, supervisions


def trim_supervisions_to_recordings(
    recordings: Union[Recording, RecordingSet], supervisions: Iterable[SupervisionSegment],
    verbose: bool = True) -> SupervisionSet:
    """Keep supervisions within their recording's duration, trimming overruns."""
    if isinstance(recordings, Recording):
        recordings = RecordingSet([recordings])
    id2rec = {r.id: r for r in recordings}
    sups = []
    removed = 0
    trimmed = 0
    for s in supervisions:
        end = id2rec[s.recording_id].duration
        if s.start > end:
            removed += 1
            continue
        if s.end > end:
            trimmed += 1
            s = s.trim(end=end)
        sups.append(s)
    if verbose and removed:
        logging.warning(f"Removed {removed} supervisions starting after the end of the recording.")
    if verbose and trimmed:
        logging.warning(f"Trimmed {trimmed} supervisions exceeding the end of the recording.")
    return SupervisionSet.from_segments(sups)


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
        for key, value in s.custom.items():
            if isinstance(value, Array):
                validate_array(value, read_data=read_data)
            elif isinstance(value, TemporalArray):
                validate_temporal_array(value, read_data=read_data)
                if not isclose(s.duration, value.duration):
                    logging.warning(
                        f"SupervisionSegment {s.id}: possibly mismatched duration "
                        f"between supervision ({s.duration}s) and temporal array in "
                        f"custom field '{key}' (duration={value.duration})."
                    )


@register_validator
def validate_features(
    f: Features, read_data: bool = False, feats_data: Optional[np.ndarray] = None) -> None:
    assert f.start >= 0, f"Features: start has to be greater than 0 (is {f.start})"
    assert f.duration > 0, f"Features: duration has to be greater than 0 (is {f.duration})"
    assert f.num_frames > 0, f"Features: num_frames has to be greater than 0 (is {f.num_frames})"
    assert f.num_features > 0, (
        f"Features: num_features has to be greater than 0 (is {f.num_features})"
    )
    assert f.sampling_rate > 0, (
        f"Features: sampling_rate has to be greater than 0 (is {f.sampling_rate})"
    )
    assert f.frame_shift > 0, (
        f"Features: frame_shift has to be greater than 0 (is {f.frame_shift})"
    )
    window_hop = round(f.frame_shift * f.sampling_rate, ndigits=12)
    assert float(int(window_hop)) == window_hop, (
        f"Features: frame_shift of {f.frame_shift} is physically impossible with "
        f"sampling rate {f.sampling_rate} (fractional window hop {window_hop})."
    )
    expected_num_frames = compute_num_frames(
        duration=f.duration, frame_shift=f.frame_shift, sampling_rate=f.sampling_rate)
    assert expected_num_frames == f.num_frames, (
        f"Features: inconsistent manifest: declared num_frames is {f.num_frames} but "
        f"duration ({f.duration}s) / frame_shift ({f.frame_shift}s) gives "
        f"{expected_num_frames} frames."
    )
    if read_data or feats_data is not None:
        if read_data:
            feats_data = f.load()
        n_fr, n_ft = feats_data.shape[-2:]
        assert f.num_frames == n_fr, (
            f"Features: expected num_frames: {f.num_frames}, actual: {n_fr}"
        )
        assert f.num_features == n_ft, (
            f"Features: expected num_features: {f.num_features}, actual: {n_ft}"
        )


@register_validator
def validate_array(arr: Array, read_data: bool = False) -> None:
    if read_data:
        data = arr.load()
        assert list(data.shape) == list(arr.shape)


@register_validator
def validate_temporal_array(arr: TemporalArray, read_data: bool = False) -> None:
    assert arr.temporal_dim >= 0, "TemporalArray: temporal_dim cannot be negative."
    assert arr.temporal_dim < arr.ndim, (
        f"TemporalArray: temporal_dim {arr.temporal_dim} cannot exceed ndim {arr.ndim}."
    )
    assert arr.frame_shift > 0, "TemporalArray: frame_shift must be positive."
    assert arr.start >= 0, "TemporalArray: start must be non-negative."
    if read_data:
        data = arr.load()
        assert list(data.shape) == list(arr.shape)


def validate_cut(c, read_data: bool = False) -> None:
    from lhotse_tpu_torch.cut import MixedCut, MonoCut, PaddingCut

    if isinstance(c, MixedCut):
        assert len(c.tracks) > 0, f"MixedCut {c.id}: must have at least one track."
        for idx, track in enumerate(c.tracks):
            validate_cut(track.cut, read_data=read_data)
            assert track.offset >= 0, f"MixedCut {c.id}: track {idx} has a negative offset."
        return

    assert c.start >= 0, f"Cut {c.id}: start must be 0 or greater (got {c.start})"
    assert c.duration > 0, f"Cut {c.id}: duration must be greater than 0 (got {c.duration})"
    assert c.sampling_rate > 0, (
        f"Cut {c.id}: sampling_rate must be greater than 0 (got {c.sampling_rate})"
    )
    assert c.has_features or c.has_recording, (
        f"Cut {c.id}: must have either Features or Recording attached."
    )

    if isinstance(c, PaddingCut):
        return

    if c.has_features:
        validate_features(c.features)
        assert c.channel == c.features.channels
        if read_data:
            feats = c.load_features()
            n_fr, n_ft = feats.shape[-2:]
            assert c.num_frames == n_fr, (
                f"Cut {c.id}: expected num_frames: {c.num_frames}, actual: {n_fr}"
            )
            assert c.num_features == n_ft, (
                f"Cut {c.id}: expected num_features: {c.num_features}, actual: {n_ft}"
            )

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
        for key, value in c.custom.items():
            if isinstance(value, Array):
                validate_array(value, read_data=read_data)
            elif isinstance(value, TemporalArray):
                validate_temporal_array(value, read_data=read_data)
                if not isclose(c.duration, value.duration):
                    logging.warning(
                        f"Cut {c.id}: possibly mismatched duration between cut "
                        f"({c.duration}s) and temporal array in custom field '{key}' "
                        f"(duration={value.duration})."
                    )
                assert overlaps(c, value), (
                    f"Cut {c.id}: TemporalArray at custom field '{key}' does not "
                    f"overlap with the cut's time span."
                )


@register_validator
def validate_recording_set(recordings: RecordingSet, read_data: bool = False) -> None:
    rates = set()
    ids = Counter()
    for r in recordings:
        validate_recording(r, read_data=read_data)
        rates.add(r.sampling_rate)
        ids[r.id] += 1
    if len(rates) > 1:
        logging.warning(
            f"RecordingSet contains recordings with different sampling rates ({rates})."
        )
    assert not ids or ids.most_common(1)[0][1] <= 1, (
        "RecordingSet has recordings with duplicated IDs."
    )


@register_validator
def validate_supervision_set(supervisions: SupervisionSet, **kwargs) -> None:
    ids = Counter()
    for s in supervisions:
        validate_supervision(s)
        ids[s.id] += 1
    assert not ids or ids.most_common(1)[0][1] <= 1, (
        "SupervisionSet has supervisions with duplicated IDs."
    )
    supervisions._index_by_recording_id_and_cache()
    for rid, sups in supervisions._segments_by_recording_id.items():
        cntr_per_channel = defaultdict(int)
        for s in sups:
            c = s.channel if isinstance(s.channel, int) else tuple(s.channel)
            cntr_per_channel[c] += int(s.start == 0)
        for channel, count in cntr_per_channel.items():
            if count > 1:
                logging.warning(
                    f"SupervisionSet contains {count} supervisions starting at 0 for "
                    f"recording {rid} (channel {channel}). Did you forget to set "
                    f"supervision start times?"
                )


@register_validator
def validate_feature_set(features: FeatureSet, read_data: bool = False) -> None:
    first = next(iter(features))
    sampling_rate = first.sampling_rate
    num_features = first.num_features
    features_type = first.type
    for idx, f in enumerate(features):
        validate_features(f, read_data=read_data)
        assert f.sampling_rate == sampling_rate, (
            f"FeatureSet: mismatched sampling rate at index {idx}"
        )
        assert f.num_features == num_features, (
            f"FeatureSet: mismatched num_features at index {idx}"
        )
        assert f.type == features_type, f"FeatureSet: mismatched feature type at index {idx}"


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


def validate_cut_set(cuts, read_data: bool = False) -> None:
    """Validate every cut in ``cuts`` (parity: reference ``qa.py:507``)."""
    for c in cuts:
        validate_cut(c, read_data=read_data)


def validate_shar(in_dir, read_data: bool = False) -> None:
    """
    Integrity check of a Shar directory (a capability beyond the reference):

    - every data field has exactly as many shards as the cuts manifest;
    - per shard, each field tar holds one (data, meta) member pair per cut,
      with member ids aligned to the cut ids in order;
    - ``.idx`` sidecars (when present) have strictly increasing offsets and
      a sentinel equal to the file size;
    - with ``read_data=True``, every cut's declared fields load.

    Raises AssertionError on the first violation.
    """
    import tarfile
    from pathlib import Path

    from lhotse_tpu_torch.serialization import extension_contains, load_jsonl, open_best
    from lhotse_tpu_torch.shar.readers.lazy import _discover_fields

    in_dir = Path(in_dir)
    _, streams = _discover_fields(in_dir)
    data_fields = sorted(set(streams) - {"cuts"})
    num_shards = len(streams["cuts"])
    for field in data_fields:
        assert len(streams[field]) == num_shards, (
            f"Shar field '{field}' has {len(streams[field])} shards, but the "
            f"cuts manifest has {num_shards}."
        )

    def _index_ok(data_path: Path) -> None:
        from lhotse_tpu_torch.indexing import index_file_path, read_index

        idx = index_file_path(data_path)
        if not idx.is_file():
            return
        offsets = read_index(idx)
        assert (np.diff(offsets.astype(np.int64)) > 0).all(), (
            f"Index offsets not strictly increasing: {idx}"
        )
        size = data_path.stat().st_size
        if data_path.suffix == ".tar":
            # Tar archives carry trailing zero-block padding past the last
            # member: the sentinel marks the end of data, not of the file.
            assert int(offsets[-1]) <= size, (
                f"Index sentinel {int(offsets[-1])} exceeds file size {size}: {idx}"
            )
        else:
            assert int(offsets[-1]) == size, (
                f"Index sentinel {int(offsets[-1])} != file size {size}: {idx}"
            )

    for shard in range(num_shards):
        cuts_path = Path(streams["cuts"][shard])
        cut_ids = [d["id"] for d in load_jsonl(cuts_path)]
        if not extension_contains(".gz", cuts_path):
            _index_ok(cuts_path)
        for field in data_fields:
            tar_path = Path(streams[field][shard])
            with open_best(tar_path, "rb") as f:
                with tarfile.open(fileobj=f, mode="r|") as tf:
                    member_ids = [
                        m.name.rsplit(".", 1)[0]
                        for k, m in enumerate(tf)
                        if k % 2 == 0  # data member of each (data, meta) pair
                    ]
            assert len(member_ids) == len(cut_ids), (
                f"Shard {shard} field '{field}': {len(member_ids)} tar samples "
                f"vs {len(cut_ids)} cuts."
            )
            for pos, (mid, cid) in enumerate(zip(member_ids, cut_ids)):
                assert mid == cid, (
                    f"Shard {shard} field '{field}' position {pos}: tar member "
                    f"'{mid}' does not match cut id '{cid}'."
                )
            _index_ok(tar_path)

    if read_data:
        from lhotse_tpu_torch.cut import CutSet

        for cut in CutSet.from_shar(in_dir=in_dir):
            for field in data_fields:
                if field == "recording":
                    loader = cut.load_audio if cut.has_recording else None
                elif field == "features":
                    loader = cut.load_features if cut.has_features else None
                elif cut.has_custom(field):
                    loader = getattr(cut, f"load_{field}")
                else:
                    loader = None
                assert loader is not None, (
                    f"Cut '{cut.id}' is missing the '{field}' field its shar "
                    f"directory declares."
                )
                arr = loader()
                assert arr is not None, (
                    f"Cut '{cut.id}' field '{field}' failed to load."
                )
