"""
MixedCut — a cut defined as an expression over other cuts (copied from
``lhotse_tpu/cut/mixed.py``).

Each :class:`MixTrack` names a DataCut/PaddingCut, the time offset where it
enters the mix, and an SNR relative to the mix's reference track (muted
reference tracks can ride along purely to pin the SNR math).  Nothing is
summed until ``load_audio``/``load_features``: the same MixedCut mixes in
the waveform domain or, for precomputed log-mel features, directly in the
feature domain via the extractor's ``mix``/``compute_energy``.

The track plots need matplotlib, imported at call time. Left out:
``load_video``, which raises ``NotImplementedError``.
"""
from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass
from functools import partial, reduce
from io import BytesIO
from operator import add
from typing import Any, Callable, Dict, Generator, Iterable, List, Optional, Tuple, Union

import numpy as np

from lhotse_tpu_torch.audio import Recording, VideoInfo, get_audio_duration_mismatch_tolerance
from lhotse_tpu_torch.audio.backend import save_audio
from lhotse_tpu_torch.audio.mixer import AudioMixer, audio_energy
from lhotse_tpu_torch.augmentation import (
    AudioTransform, LoudnessNormalization, ReverbWithImpulseResponse)
from lhotse_tpu_torch.cut.base import Cut
from lhotse_tpu_torch.cut.data import DataCut
from lhotse_tpu_torch.cut.padding import PaddingCut
from lhotse_tpu_torch.features.base import FeatureExtractor, create_default_feature_extractor
from lhotse_tpu_torch.features.io import FeaturesWriter
from lhotse_tpu_torch.features.mixer import FeatureMixer
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import (
    DEFAULT_PADDING_VALUE, LOG_EPSILON, Decibels, Pathlike, Seconds, add_durations, compute_num_frames,
    compute_num_samples, fastcopy, hash_str_to_int, merge_items_with_delimiter, not_ported,
    overlaps, perturb_num_samples, rich_exception_info, uuid4)


@dataclass
class MixTrack:
    """One ingredient of a mix: a cut + where/how loudly it enters."""

    cut: Cut
    type: str = None
    offset: Seconds = 0.0
    snr: Optional[Decibels] = None
    tag: Optional[str] = None
    is_snr_reference: bool = False
    mute: bool = False

    def __post_init__(self):
        self.type = type(self.cut).__name__

    @staticmethod
    def from_dict(data: dict):
        from lhotse_tpu_torch.cut.set import deserialize_cut

        payload = data.pop("cut")
        payload["type"] = data.pop("type")
        return MixTrack(deserialize_cut(payload), **data)

    def to_dict(self) -> Dict:
        d = {"cut": self.cut.to_dict(), "type": self.type, "offset": self.offset}
        # Optional fields serialize only when meaningful.
        for name in ("snr", "tag"):
            if getattr(self, name) is not None:
                d[name] = getattr(self, name)
        for name in ("is_snr_reference", "mute"):
            if getattr(self, name):
                d[name] = True
        return d


# ---------------------------------------------------------------------------
# Track-selection helpers
# ---------------------------------------------------------------------------
def _get_audible_tracks(mixed_cut: "MixedCut") -> List[MixTrack]:
    audible = [t for t in mixed_cut.tracks if not t.mute]
    return audible or mixed_cut.tracks


def _get_first_non_padding_track(mixed_cut: "MixedCut") -> MixTrack:
    audible = _get_audible_tracks(mixed_cut)
    for t in audible:
        if not isinstance(t.cut, PaddingCut):
            return t
    return audible[0]


def _get_snr_reference_track(mixed_cut: "MixedCut") -> Tuple[Optional[int], MixTrack]:
    for idx, t in enumerate(mixed_cut.tracks):
        if t.is_snr_reference:
            return idx, t
    for idx, t in enumerate(mixed_cut.tracks):
        if not isinstance(t.cut, PaddingCut) and t.snr is None:
            return idx, t
    if all(t.snr is None for t in mixed_cut.tracks):
        # no SNR scaling anywhere (e.g. padding mixed with padding):
        # any track works since no gain will be derived from it
        return 0, mixed_cut.tracks[0]
    raise ValueError(f"Cannot determine SNR reference track for MixedCut '{mixed_cut.id}'.")


def _ensure_explicit_snr_reference(tracks: List[MixTrack]) -> List[MixTrack]:
    if any(t.is_snr_reference for t in tracks):
        return tracks
    for idx, t in enumerate(tracks):
        if not isinstance(t.cut, PaddingCut) and t.snr is None:
            tracks[idx] = fastcopy(t, is_snr_reference=True)
            break
    return tracks


def _snr_gain(snr: Optional[Decibels], reference_energy, own_energy) -> Optional[float]:
    """Energy ratio that brings ``own_energy`` to ``snr`` dB below the reference."""
    if snr is None or reference_energy is None or reference_energy <= 0.0:
        return None
    if own_energy <= 0.0:
        return None
    return reference_energy * (10.0 ** (-snr / 10)) / own_energy


def _scale_audio_for_snr(
    audio: np.ndarray, snr: Optional[Decibels], reference_energy: Optional[float]) -> np.ndarray:
    ratio = _snr_gain(snr, reference_energy, audio_energy(audio))
    return audio if ratio is None else np.sqrt(ratio) * audio


def _scale_features_for_snr(
    features: np.ndarray, feature_extractor: FeatureExtractor, snr: Optional[Decibels],
    reference_energy: Optional[float]) -> np.ndarray:
    ratio = _snr_gain(snr, reference_energy, feature_extractor.compute_energy(features))
    return features if ratio is None else feature_extractor.scale(features, ratio)


@dataclass
class MixedCut(Cut):
    """
    A lazy sum of tracks: overlaying (noise/music/babble mixing), appending
    (with gaps), and padding are all expressed as MixedCuts.  The mix — in
    the audio or feature domain — happens on load; post-mix transforms
    (reverb, loudness) live in ``transforms``.
    """

    id: str
    tracks: List[MixTrack]
    transforms: Optional[List[AudioTransform]] = None

    # -- derived geometry ---------------------------------------------------------

    @property
    def supervisions(self) -> List[SupervisionSegment]:
        """All audible tracks' supervisions, shifted by their track offsets."""
        return [
            sup.with_offset(t.offset)
            for t in _get_audible_tracks(self)
            for sup in t.cut.supervisions
        ]

    start = property(lambda self: 0)

    @property
    def duration(self) -> Seconds:
        ends = (t.offset + t.cut.duration for t in _get_audible_tracks(self))
        return round(max(ends), ndigits=8)

    @property
    def channel(self) -> Union[int, List[int]]:
        n = self.num_channels
        return list(range(n)) if n > 1 else 0

    @property
    def num_channels(self) -> Optional[int]:
        return max(t.cut.num_channels for t in _get_audible_tracks(self))

    # The "lead" cut (first audible non-padding track) answers all questions
    # about what data the mix carries.
    @property
    def _lead(self) -> DataCut:
        return _get_first_non_padding_track(self).cut

    has_features = property(lambda self: self._lead.has_features)
    has_recording = property(lambda self: self._lead.has_recording)
    has_video = property(lambda self: self._lead.has_video)
    frame_shift = property(lambda self: self._lead.frame_shift)
    sampling_rate = property(lambda self: self._lead.sampling_rate)
    num_features = property(lambda self: self._lead.num_features)
    is_in_memory = property(lambda self: any(t.cut.is_in_memory for t in _get_audible_tracks(self)))

    def has(self, field: str) -> bool:
        return self._lead.has(field)

    @property
    def num_frames(self) -> Optional[int]:
        if not self.has_features:
            return None
        return compute_num_frames(
            duration=self.duration, frame_shift=self.frame_shift, sampling_rate=self.sampling_rate)

    @property
    def num_samples(self) -> Optional[int]:
        return compute_num_samples(self.duration, self.sampling_rate)

    @property
    def features_type(self) -> Optional[str]:
        return self._lead.features.type if self.has_features else None

    @property
    def video(self) -> Optional[VideoInfo]:
        if not self.has_video:
            return None
        v = self._lead.video
        return v.copy_with(num_frames=compute_num_samples(self.duration, v.fps))

    def iter_data(self) -> Generator:
        return self._lead.iter_data()

    # -- custom-field magic --------------------------------------------------------

    def __setattr__(self, key: str, value: Any) -> None:
        # A MixedCut holds no `custom` of its own; unknown attributes land on
        # the lead cut by convention.
        if key in self.__dataclass_fields__:
            super().__setattr__(key, value)
        else:
            setattr(self._lead, key, value)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError()
        if name.startswith("load_"):
            return partial(self.load_custom, name[5:])
        if name == "custom":
            merged = {}
            for t in _get_audible_tracks(self):
                merged.update(t.cut.custom or {})
            return merged
        carriers = self._tracks_with_custom(name)
        if carriers:
            return getattr(carriers[0][1], name)
        raise AttributeError(f"No such attribute: '{name}'")

    def _tracks_with_custom(self, attr: str) -> list:
        return [
            (idx, t.cut)
            for idx, t in enumerate(self.tracks)
            if isinstance(t.cut, DataCut)
            and not t.mute
            and t.cut.custom is not None
            and attr in t.cut.custom
        ]

    def has_custom(self, name: str) -> bool:
        carriers = self._tracks_with_custom(name)
        return bool(carriers) and hasattr(carriers[0][1], name)

    def load_custom(self, name: str) -> np.ndarray:
        """
        Load a custom Array/TemporalArray/Recording attribute with the mix's
        padding applied; multiple carrier tracks are combined only for
        Recording-type attributes.
        """
        from lhotse_tpu_torch.array import Array, pad_array

        carriers = self._tracks_with_custom(name)
        if not carriers:
            raise AssertionError(
                f"No non-padding tracks with custom attribute '{name}' found "
                f"in this MixedCut."
            )
        lead_idx, lead_cut = carriers[0]
        manifest = getattr(lead_cut, name)

        if len(carriers) > 1:
            if isinstance(manifest, Recording):
                return self._sum_custom_recordings(name, carriers)
            raise ValueError(
                f"This MixedCut has {len(carriers)} non-padding tracks with "
                f"custom attribute '{name}'; mixing custom attributes is only "
                f"supported for Recording-type attributes."
            )

        if isinstance(manifest, Array):
            return lead_cut.load_custom(name)

        lead_offset = self.tracks[lead_idx].offset
        if isinstance(manifest, Recording):
            return (
                manifest.to_cut()
                .pad(duration=manifest.duration + lead_offset, direction="left")
                .pad(duration=self.duration, direction="right")
                .load_audio()
            )

        # TemporalArray: pad with the value recorded by any padding track.
        pad_value = DEFAULT_PADDING_VALUE
        for t in self.tracks:
            if isinstance(t.cut, PaddingCut) and t.cut.custom and name in t.cut.custom:
                pad_value = t.cut.custom[name]
                break
        return pad_array(
            lead_cut.load_custom(name), temporal_dim=manifest.temporal_dim,
            frame_shift=manifest.frame_shift, offset=lead_offset, padded_duration=self.duration,
            pad_value=pad_value)

    def _sum_custom_recordings(self, name: str, carriers: list) -> np.ndarray:
        """Sum one custom Recording field across tracks (e.g. per-cut target
        audio of appended cuts)."""
        lead_idx, lead_cut = carriers[0]
        sr = getattr(lead_cut, name).sampling_rate
        mixer = AudioMixer(
            base_audio=lead_cut.load_custom(name), sampling_rate=sr,
            base_offset=self.tracks[lead_idx].offset)
        for idx, cut in carriers[1:]:
            mixer.add_to_mix(audio=cut.load_custom(name), offset=self.tracks[idx].offset)
        return _settle_length(
            mixer.mixed_audio, compute_num_samples(self.duration, sr), sr, pad_mode="constant")

    # -- serialization ----------------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "id": self.id, "tracks": [t.to_dict() for t in self.tracks],
            "type": type(self).__name__}
        if self.transforms:
            d["transforms"] = [t.to_dict() for t in self.transforms]
        return d

    @staticmethod
    def from_dict(data: dict) -> "MixedCut":
        data.pop("type", None)
        transforms = None
        if "transforms" in data:
            transforms = [AudioTransform.from_dict(t) for t in data["transforms"]]
        tracks = [MixTrack.from_dict(t) for t in data["tracks"]]
        if "snr_reference" in data:
            tracks.append(
                fastcopy(
                    MixTrack.from_dict(data["snr_reference"]),
                    is_snr_reference=True,
                    mute=True,
                )
            )
        return MixedCut(id=data["id"], tracks=tracks, transforms=transforms)

    # -- per-track rebuilding: the engine behind all the lazy builders ------------------

    def _rebuild_tracks(
        self, cut_op: Callable[[Cut], Cut], *, suffix: str = "", affix_id: bool = False,
        offset_op: Optional[Callable[[Seconds], Seconds]] = None,
        warn_features: Optional[str] = None, require_recording: Optional[str] = None,
        keep_transforms: bool = False) -> "MixedCut":
        """Apply ``cut_op`` to every track's cut (and optionally remap the
        track offsets), producing a new MixedCut."""
        if require_recording is not None and not self.has_recording:
            raise AssertionError(f"Cannot {require_recording} on a MixedCut without Recording.")
        if warn_features is not None and self.has_features:
            logging.warning(
                f"Applying {warn_features} on a MixedCut with pre-computed "
                f"features: the feature manifests will be detached."
            )
        tracks = []
        for t in self.tracks:
            updates = {"cut": cut_op(t.cut)}
            if offset_op is not None:
                updates["offset"] = offset_op(t.offset)
            tracks.append(fastcopy(t, **updates))
        return MixedCut(
            id=f"{self.id}{suffix}" if affix_id else self.id, tracks=tracks,
            transforms=list(self.transforms) if keep_transforms and self.transforms else None)

    def _scaled_offset(self, factor: float) -> Callable[[Seconds], Seconds]:
        sr = self.sampling_rate

        def scale(offset: Seconds) -> Seconds:
            return round(
                perturb_num_samples(compute_num_samples(offset, sr), factor) / sr, ndigits=8)

        return scale

    def _added_mix_transform(self, transform, suffix: str, affix_id: bool) -> "MixedCut":
        chain = list(self.transforms) if self.transforms is not None else []
        chain.append(transform)
        return fastcopy(self, id=f"{self.id}{suffix}" if affix_id else self.id, transforms=chain)

    # -- lazy builders --------------------------------------------------------------------

    def move_to_memory(
        self, audio_format: str = "wav", load_audio: bool = True, load_features: bool = True,
        load_custom: bool = True) -> "MixedCut":
        return self._rebuild_tracks(
            lambda c: c.move_to_memory( audio_format=audio_format, load_audio=load_audio, load_features=load_features, load_custom=load_custom, ),
            keep_transforms=True)

    def resample(
        self, sampling_rate: int, affix_id: bool = False, recording_field: Optional[str] = None,
    ) -> "MixedCut":
        """Lazy resample of every track (feature manifests detach)."""
        return self._rebuild_tracks(
            lambda c: c.resample(sampling_rate, recording_field=recording_field),
            suffix=f"_rs{sampling_rate}", affix_id=affix_id, require_recording="resample")

    def perturb_speed(self, factor: float, affix_id: bool = True) -> "MixedCut":
        """Speed-perturb every track; offsets rescale via sample counts."""
        return self._rebuild_tracks(
            lambda c: c.perturb_speed(factor=factor, affix_id=affix_id), suffix=f"_sp{factor}",
            affix_id=affix_id, offset_op=self._scaled_offset(factor),
            warn_features="speed perturbation", require_recording="perturb speed")

    def perturb_tempo(self, factor: float, affix_id: bool = True) -> "MixedCut":
        """Tempo-perturb every track; offsets rescale via sample counts."""
        return self._rebuild_tracks(
            lambda c: c.perturb_tempo(factor=factor, affix_id=affix_id), suffix=f"_tp{factor}",
            affix_id=affix_id, offset_op=self._scaled_offset(factor),
            warn_features="tempo perturbation", require_recording="perturb tempo")

    def perturb_volume(self, factor: float, affix_id: bool = True) -> "MixedCut":
        return self._rebuild_tracks(
            lambda c: c.perturb_volume(factor=factor, affix_id=affix_id), suffix=f"_vp{factor}",
            affix_id=affix_id, warn_features="volume perturbation",
            require_recording="perturb volume")

    def clip_amplitude(
        self, hard: bool = False, gain_db: float = 0.0, normalize: bool = True,
        oversampling: Optional[int] = 2, affix_id: bool = True) -> "MixedCut":
        return self._rebuild_tracks(
            lambda c: c.clip_amplitude( hard=hard, gain_db=gain_db, normalize=normalize, oversampling=oversampling, affix_id=affix_id, ),
            suffix=f"_cl{gain_db}", affix_id=affix_id, warn_features="clipping",
            require_recording="apply clipping")

    def narrowband(
        self, codec: str, restore_orig_sr: bool = True, affix_id: bool = True) -> "MixedCut":
        """Telephone-codec bandwidth reduction of every track (the JAX
        package's MixedCut has no ``narrowband``)."""
        return self._rebuild_tracks(
            lambda c: c.narrowband(codec=codec, restore_orig_sr=restore_orig_sr, affix_id=affix_id),
            suffix=f"_nb_{codec}", affix_id=affix_id, warn_features="narrowband",
            require_recording="apply narrowband")

    def dereverb_wpe(self, affix_id: bool = True) -> "MixedCut":
        """WPE dereverberation of every track (the JAX package's MixedCut has
        no ``dereverb_wpe``)."""
        return self._rebuild_tracks(
            lambda c: c.dereverb_wpe(affix_id=affix_id), suffix="_wpe", affix_id=affix_id,
            warn_features="WPE dereverberation", require_recording="apply WPE")

    def normalize_loudness(
        self, target: float, mix_first: bool = True, affix_id: bool = False) -> Cut:
        """Loudness normalization applied to the mix or per source track."""
        if not self.has_recording:
            raise AssertionError("Cannot normalize loudness on a MixedCut without Recording.")
        if self.has_features:
            logging.warning(
                "Normalizing loudness on a MixedCut with pre-computed features: "
                "the feature manifests will be detached."
            )
        if mix_first:
            return self._added_mix_transform(
                LoudnessNormalization(target=target), f"_ln{target}", affix_id)
        return self._rebuild_tracks(
            lambda c: c.normalize_loudness(target=target, affix_id=affix_id), suffix=f"_ln{target}",
            affix_id=affix_id)

    def compress(
        self, codec: str = "opus", compression_level: float = 0.99,
        compress_custom_fields: bool = False) -> "MixedCut":
        return self._rebuild_tracks(
            lambda c: c.compress(codec, compression_level, compress_custom_fields),
            require_recording="compress")

    def reverb_rir(
        self, rir_recording: Optional["Recording"] = None, normalize_output: bool = True,
        early_only: bool = False, affix_id: bool = True, rir_channels: List[int] = [0],
        room_rng_seed: Optional[int] = None, source_rng_seed: Optional[int] = None,
        mix_first: bool = True) -> "MixedCut":
        """
        Reverberate the mix with one RIR (``mix_first=True``) or each track
        with its own RIR draw (same room seed, distinct source seeds —
        several speakers in one simulated room).
        """
        if not self.has_recording:
            raise AssertionError("Cannot apply reverberation on a MixedCut without Recording.")
        if self.has_features:
            logging.warning(
                "Reverberating a MixedCut with pre-computed features: the "
                "feature manifests will be detached."
            )
        if rir_recording is not None and any(c >= rir_recording.num_channels for c in rir_channels):
            raise AssertionError("Invalid channel index in `rir_channels`.")
        audible = _get_audible_tracks(self)
        if len(rir_channels) not in (1, len(audible)):
            raise AssertionError(
                "Invalid number of channels in `rir_channels`: must be 1 or "
                "equal to the number of tracks."
            )

        nonce = str(uuid4())
        if room_rng_seed is None:
            room_rng_seed = hash_str_to_int(nonce + self.id, max_value=2**31)
        if source_rng_seed is None:
            per_track_seeds = [
                hash_str_to_int(nonce + t.cut.id, max_value=2**31) for t in self.tracks
            ]
            source_rng_seed = per_track_seeds[0]
        else:
            per_track_seeds = [source_rng_seed] * len(self.tracks)

        if mix_first:
            synth = None
            if rir_recording is None:
                from lhotse_tpu_torch.augmentation.utils import FastRandomRIRGenerator

                synth = FastRandomRIRGenerator(
                    sr=self.sampling_rate, room_seed=room_rng_seed, source_seed=source_rng_seed)
            return self._added_mix_transform(
                ReverbWithImpulseResponse( rir=rir_recording, normalize_output=normalize_output, early_only=early_only, rir_channels=rir_channels if rir_channels is not None else [0], rir_generator=synth, ),
                "_rvb", affix_id)

        if len(rir_channels) == 1:
            channel_per_track = rir_channels * len(self.tracks)
        else:
            feed = iter(rir_channels)
            channel_per_track = [rir_channels[0] if t.mute else next(feed) for t in self.tracks]
        new_tracks = [
            fastcopy( t, cut=t.cut.reverb_rir( rir_recording=rir_recording, normalize_output=normalize_output, early_only=early_only, affix_id=affix_id, rir_channels=[ch], room_rng_seed=room_rng_seed, source_rng_seed=seed, ), ) for t,
            ch, seed in zip(self.tracks, channel_per_track, per_track_seeds)]
        return MixedCut(id=f"{self.id}_rvb" if affix_id else self.id, tracks=new_tracks)

    # -- windowing --------------------------------------------------------------------------

    def truncate(
        self, *, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        keep_excessive_supervisions: bool = True, preserve_id: bool = False,
        _supervisions_index: Optional[Dict[str, Any]] = None) -> Cut:
        """
        Window the mix: each track is truncated/re-offset; tracks that fall
        completely outside are dropped.  Degenerate results collapse to a
        PaddingCut or a single plain cut.
        """
        if offset < 0:
            raise AssertionError(f"Offset for truncate must be non-negative (provided {offset}).")
        sr = self.sampling_rate
        old_duration = self.duration
        if duration is None:
            window_end = add_durations(old_duration, -offset, sampling_rate=sr)
        else:
            window_end = add_durations(offset, duration, sampling_rate=sr)

        kept: List[MixTrack] = []
        for t in sorted(self.tracks, key=lambda t: t.offset):
            reshaped = self._truncate_track(
                t, offset, duration, window_end, old_duration, keep_excessive_supervisions,
                preserve_id, _supervisions_index)
            if reshaped is not None:
                kept.append(reshaped)

        if not any(not isinstance(t.cut, PaddingCut) for t in kept):
            return PaddingCut(
                id=self.id if preserve_id else str(uuid4()), duration=duration, sampling_rate=sr,
                feat_value=0.0, num_samples=compute_num_samples(duration, sr))
        if len(kept) == 1:
            return kept[0].cut

        out = MixedCut(id=self.id if preserve_id else str(uuid4()), tracks=kept)
        # The SNR reference may have been cut away; promote the first
        # non-padding track so SNR math stays well-defined.
        lost_reference = not any(t.is_snr_reference for t in out.tracks) and all(
            t.snr is not None or isinstance(t.cut, PaddingCut) for t in out.tracks
        )
        if lost_reference:
            for idx, t in enumerate(out.tracks):
                if not isinstance(t.cut, PaddingCut):
                    out.tracks[idx] = fastcopy(t, snr=None, is_snr_reference=True)
                    break
        return out

    def _truncate_track(
        self, track, offset, duration, window_end, old_duration, keep_excessive, preserve_id,
        sup_index) -> Optional[MixTrack]:
        sr = self.sampling_rate
        track_end = add_durations(track.offset, track.cut.duration, sampling_rate=sr)
        if track_end < offset:
            return None
        inner_offset = max(add_durations(offset, -track.offset, sampling_rate=sr), 0)
        new_track_offset = max(add_durations(track.offset, -offset, sampling_rate=sr), 0)
        past_window = 0
        if track_end > window_end:
            bound = window_end if duration is not None else old_duration
            past_window = add_durations(track_end, -bound, sampling_rate=sr)
        new_len = add_durations(track.cut.duration, -inner_offset, -past_window, sampling_rate=sr)
        if new_len <= 0:
            return None
        return MixTrack(
            cut=track.cut.truncate( offset=inner_offset, duration=new_len, keep_excessive_supervisions=keep_excessive, preserve_id=preserve_id, _supervisions_index=sup_index, ),
            offset=new_track_offset, snr=track.snr, tag=track.tag,
            is_snr_reference=track.is_snr_reference, mute=track.mute)

    def extend_by(self, **kwargs) -> "MixedCut":
        raise ValueError("The extend_by() method is not defined for a MixedCut.")

    def pad(
        self, duration: Seconds = None, num_frames: int = None, num_samples: int = None,
        pad_feat_value: float = LOG_EPSILON, direction: str = "right", preserve_id: bool = False,
        pad_value_dict: Optional[Dict[str, Union[int, float]]] = None) -> Cut:
        from lhotse_tpu_torch.cut.set import pad

        return pad(
            self, duration=duration, num_frames=num_frames, num_samples=num_samples,
            pad_feat_value=pad_feat_value, direction=direction, preserve_id=preserve_id,
            pad_value_dict=pad_value_dict)

    # -- unmixing -----------------------------------------------------------------------------

    def unmix(self, tag: Optional[str] = None) -> List[Cut]:
        """
        Recover time-aligned constituents: one cut per non-padding track, or
        with ``tag`` exactly two cuts, ``[without_tag, with_tag]`` (muted
        SNR-reference tracks ride along to keep SNR math exact).
        """
        real = [t for t in _get_audible_tracks(self) if not isinstance(t.cut, PaddingCut)]
        if tag is None:
            return [_to_unmixed_cut(self, [t]) for t in real]
        return [
            _to_unmixed_cut(self, [t for t in real if t.tag != tag]),
            _to_unmixed_cut(self, [t for t in real if t.tag == tag])]

    def to_mono(self, encoding: str = "wav", **kwargs) -> "Cut":
        """Render the whole mix to a single-channel in-memory MonoCut, whose
        supervisions point at the rendered recording (the JAX package keeps
        their old ``recording_id``, so its result fails ``validate``)."""
        wave = self.load_audio(mono_downmix=True)
        buf = BytesIO()
        save_audio(buf, wave, self.sampling_rate, format=encoding)
        rec = Recording.from_bytes(buf.getvalue(), recording_id=self.id)
        return fastcopy(
            rec.to_cut(),
            supervisions=[fastcopy(s, channel=0, recording_id=rec.id) for s in self.supervisions],
            custom=_get_first_non_padding_track(self).cut.custom)

    # -- loading ---------------------------------------------------------------------------------

    @rich_exception_info
    def load_features(self, mixed: bool = True) -> Optional[np.ndarray]:
        """
        Mix the tracks in the feature domain (requires all tracks to carry
        compatible precomputed features).  ``mixed=False`` returns the padded
        per-track stack instead.
        """
        if not self.has_features:
            return None
        tracks = _get_audible_tracks(self)
        lead_track, lead_cut = tracks[0], tracks[0].cut

        # Shortcut: one real cut + padding only needs a fill, not a mixer.
        only_padding_rest = tracks[1:] and all(isinstance(t.cut, PaddingCut) for t in tracks[1:])
        if mixed and lead_track.snr is None and only_padding_rest:
            fill = tracks[1].cut.feat_value
            lead_feats = lead_cut.load_features()
            canvas_shape = (self.num_frames, self.num_features) + lead_feats.shape[2:]
            canvas = np.full(canvas_shape, fill, dtype=np.float64)
            canvas[: lead_cut.num_frames, ...] = lead_feats
            return canvas

        # The SNR reference can differ from the lead track (e.g. after left
        # padding); its energy anchors every SNR gain.
        _, ref_track = _get_snr_reference_track(self)
        extractor = create_default_feature_extractor(ref_track.cut.features_type)
        ref_feats = ref_energy = None
        if ref_track is not lead_track:
            ref_feats = ref_track.cut.load_features()
            ref_energy = extractor.compute_energy(ref_feats)

        mixer = FeatureMixer(
            feature_extractor=extractor,
            base_feats=_scale_features_for_snr( lead_cut.load_features(), extractor, lead_track.snr, ref_energy ),
            frame_shift=lead_cut.frame_shift, reference_energy=ref_energy)
        for t in tracks[1:]:
            feats = (
                ref_feats
                if t is ref_track and ref_feats is not None
                else t.cut.load_features()
            )
            mixer.add_to_mix(
                feats=feats, snr=t.snr, offset=t.offset, sampling_rate=t.cut.sampling_rate)

        if not mixed:
            return mixer.unmixed_feats
        feats = mixer.mixed_feats
        # One-frame drift comes from duration rounding; reconcile it.
        drift = feats.shape[0] - self.num_frames
        if drift == 1:
            feats = feats[: self.num_frames, :]
        elif drift == -1:
            feats = np.concatenate((feats, feats[-1:, :]), axis=0)
        if feats.shape[0] != self.num_frames:
            raise AssertionError(
                "Inconsistent number of frames in a MixedCut — please report "
                "this with the output of print(cut)."
            )
        return feats

    @rich_exception_info
    def load_audio(self, mixed: bool = True, mono_downmix: bool = False) -> Optional[np.ndarray]:
        """
        Mix the tracks' waveforms.  ``mixed=False`` returns the padded
        per-track stack; ``mono_downmix`` collapses a multi-channel mix.
        """
        if not self.has_recording:
            return None
        tracks = _get_audible_tracks(self)
        lead_track, lead_cut = tracks[0], tracks[0].cut

        _, ref_track = _get_snr_reference_track(self)
        ref_audio = ref_energy = None
        if ref_track is not lead_track:
            ref_audio = ref_track.cut.load_audio()
            ref_energy = audio_energy(ref_audio)

        mixer = AudioMixer(
            _scale_audio_for_snr(lead_cut.load_audio(), lead_track.snr, ref_energy),
            sampling_rate=lead_cut.sampling_rate, reference_energy=ref_energy,
            base_offset=lead_track.offset)
        for t in tracks[1:]:
            wave = (ref_audio if t is ref_track and ref_audio is not None else t.cut.load_audio())
            mixer.add_to_mix(audio=wave, snr=t.snr, offset=t.offset)

        if not mixed:
            return mixer.unmixed_audio

        downmix = mono_downmix and any(t.type == "MultiCut" for t in tracks)
        audio = mixer.mixed_mono_audio if downmix else mixer.mixed_audio
        audio = _settle_length(audio, self.num_samples, self.sampling_rate, pad_mode="reflect")
        if audio.shape[1] != self.num_samples:
            raise AssertionError(
                f"Inconsistent number of samples in a MixedCut: expected "
                f"{self.num_samples}, the mix produced {audio.shape[1]}."
            )
        for t in self.transforms or []:
            t = t if isinstance(t, AudioTransform) else AudioTransform.from_dict(t)
            audio = t(audio, self.sampling_rate)
        return audio

    def load_video(self, *args, **kwargs):
        raise not_ported("MixedCut.load_video")

    def plot_tracks_features(self):
        import matplotlib.pyplot as plt

        tracks = _get_audible_tracks(self)
        fig, axes = plt.subplots(len(tracks))
        feats = self.load_features(mixed=False)
        lo, hi = feats.min(), feats.max()
        for k, ax in enumerate(axes):
            ax.imshow(np.flip(feats[k].transpose(1, 0), 0), vmin=lo, vmax=hi)
        return axes

    def plot_tracks_audio(self):
        import matplotlib.pyplot as plt

        waves = self.load_audio(mixed=False)
        tracks = _get_audible_tracks(self)
        fig, axes = plt.subplots(len(tracks), sharex=False, sharey=True)
        for (t, ax, wave) in zip(tracks, axes, waves):
            samples = wave.squeeze(0)
            ax.plot(np.linspace(0, self.duration, len(samples)), samples)
            for sup in t.cut.supervisions:
                sup = sup.trim(t.cut.duration)
                ax.axvspan(t.offset + sup.start, t.offset + sup.end, color="green", alpha=0.1)
        return axes

    # -- detachments ------------------------------------------------------------------------------------

    def drop_features(self) -> "MixedCut":
        if not self.has_recording:
            raise AssertionError(
                f"Cannot detach features from a MixedCut with no Recording "
                f"(cut ID = {self.id})."
            )
        return self._rebuild_tracks(lambda c: c.drop_features(), keep_transforms=True)

    def drop_recording(self) -> "MixedCut":
        if not self.has_features:
            raise AssertionError(
                f"Cannot detach recording from a MixedCut with no Features "
                f"(cut ID = {self.id})."
            )
        return self._rebuild_tracks(lambda c: c.drop_recording(), keep_transforms=True)

    def drop_supervisions(self) -> "MixedCut":
        return self._rebuild_tracks(lambda c: c.drop_supervisions(), keep_transforms=True)

    def drop_alignments(self) -> "MixedCut":
        return self._rebuild_tracks(lambda c: c.drop_alignments(), keep_transforms=True)

    def drop_in_memory_data(self) -> "MixedCut":
        return self._rebuild_tracks(lambda c: c.drop_in_memory_data(), keep_transforms=True)

    def with_features_path_prefix(self, path: Pathlike) -> "MixedCut":
        if not self.has_features:
            return self
        return self._rebuild_tracks(lambda c: c.with_features_path_prefix(path))

    def with_recording_path_prefix(self, path: Pathlike) -> "MixedCut":
        if not self.has_recording:
            return self
        return self._rebuild_tracks(lambda c: c.with_recording_path_prefix(path))

    # -- feature extraction -------------------------------------------------------------------------------

    def compute_and_store_features(
        self, extractor: FeatureExtractor, storage: FeaturesWriter, augment_fn=None,
        mix_eagerly: bool = True) -> DataCut:
        """
        Extract + persist features: eagerly (mix the waveform now, return a
        recording-less MonoCut) or per track (return a MixedCut ready for
        dynamic feature-domain mixing).
        """
        if mix_eagerly:
            from lhotse_tpu_torch.cut.mono import MonoCut

            manifest = extractor.extract_from_samples_and_store(
                samples=self.load_audio(), storage=storage, sampling_rate=self.sampling_rate,
                offset=0, channel=0, augment_fn=augment_fn)
            manifest.recording_id = self.id
            return MonoCut(
                id=self.id, start=0, duration=self.duration, channel=0,
                supervisions=[ fastcopy(s, recording_id=self.id) for s in self.supervisions ],
                features=manifest, recording=None,
                custom=self.custom if hasattr(self, "custom") else None)
        return self._rebuild_tracks(
            lambda c: c.compute_and_store_features(
                extractor=extractor, storage=storage, augment_fn=augment_fn
            )
        )

    # -- supervision manipulation ---------------------------------------------------------------------------

    def fill_supervision(self, add_empty: bool = True, shrink_ok: bool = False) -> "MixedCut":
        """Grow (or create) the single supervision to cover the full mix."""
        n = len(self.supervisions)
        if n == 0:
            if not add_empty:
                return self
            lead_idx = self.tracks.index(_get_first_non_padding_track(self))
            new_tracks = list(self.tracks)
            lead = new_tracks[lead_idx]
            whole_mix_sup = SupervisionSegment(
                id=self.id, recording_id=lead.cut.recording_id, start=-lead.offset,
                duration=self.duration, channel=-1)
            new_tracks[lead_idx] = fastcopy(
                lead, cut=fastcopy(lead.cut, supervisions=[whole_mix_sup]))
            return fastcopy(self, tracks=new_tracks)
        if n != 1:
            raise AssertionError(f"Cannot expand more than one supervision (found {n}).")
        new_tracks = []
        for t in self.tracks:
            if t.mute or not t.cut.supervisions:
                new_tracks.append(t)
                continue
            sup = t.cut.supervisions[0]
            if not shrink_ok and (sup.start < -t.offset or sup.end > self.duration):
                raise ValueError(
                    f"Cannot shrink supervision (start={sup.start}, end={sup.end}) "
                    f"to cut (start=0, duration={t.cut.duration}) with "
                    f"shrink_ok=False."
                )
            grown = fastcopy(sup, start=-t.offset, duration=self.duration)
            new_tracks.append(fastcopy(t, cut=fastcopy(t.cut, supervisions=[grown])))
        return fastcopy(self, tracks=new_tracks)

    def map_supervisions(
        self, transform_fn: Callable[[SupervisionSegment], SupervisionSegment]) -> Cut:
        out = fastcopy(self)
        for t in out.tracks:
            if isinstance(t.cut, PaddingCut) or t.mute:
                continue
            t.cut.supervisions = [s.map(transform_fn) for s in t.cut.supervisions]
        return out

    def filter_supervisions(self, predicate: Callable[[SupervisionSegment], bool]) -> Cut:
        return self._rebuild_tracks(
            lambda c: c.filter_supervisions(predicate), keep_transforms=True)

    def merge_supervisions(
        self, merge_policy: str = "delimiter",
        custom_merge_fn: Optional[Callable[[str, Iterable[Any]], Any]] = None) -> "MixedCut":
        """Fuse all supervisions into one segment on the lead track."""
        join = partial(
            merge_items_with_delimiter, delimiter="#", return_first=(merge_policy == "keep_first"))
        join_custom = custom_merge_fn or (lambda k, vs: join(map(str, vs)))

        sups = sorted(self.supervisions, key=lambda s: s.start)
        if len(sups) <= 1:
            return self
        span_start, span_end = sups[0].start, sups[-1].end
        if any(overlaps(a, b) for a, b in zip(sups, sups[1:])) and any(
            s.text is not None for s in sups
        ):
            warnings.warn(
                "You are merging overlapping supervisions with text transcripts; "
                f"the result may be unusable for ASR training (cut id: {self.id})."
            )
        custom_keys = {k for s in sups if s.custom for k in s.custom}
        ali_keys = {k for s in sups if s.alignment for k in s.alignment}
        fused = SupervisionSegment(
            id=join(s.id for s in sups),
            recording_id=join(s.recording_id for s in sups),
            start=span_start,
            duration=add_durations(span_end, -span_start, sampling_rate=self.sampling_rate),
            # channel -1: the constituents may live on different recordings.
            channel=-1,
            text=" ".join(s.text for s in sups if s.text),
            speaker=join(s.speaker for s in sups if s.speaker),
            language=join(s.language for s in sups if s.language),
            gender=join(s.gender for s in sups if s.gender),
            custom={
                k: join_custom(k, (s.custom[k] for s in sups if s.custom and k in s.custom))
                for k in custom_keys
            },
            alignment={
                k: reduce(
                    add, (s.alignment[k] for s in sups if s.alignment and k in s.alignment)
                )
                for k in ali_keys
            },
        )
        out = self.drop_supervisions()
        out._lead.supervisions = [fused]
        return out

    # -- reference-track accessors --------------------------------------------------------

    @property
    def first_non_padding_cut(self) -> DataCut:
        return _get_first_non_padding_track(self).cut

    @property
    def first_non_padding_track(self) -> MixTrack:
        return _get_first_non_padding_track(self)


def _settle_length(
    audio: np.ndarray, want: int, sampling_rate: int, *, pad_mode: str) -> np.ndarray:
    """Trim/pad sub-tolerance sample-count drift after mixing."""
    slack = compute_num_samples(
        get_audio_duration_mismatch_tolerance(), sampling_rate=sampling_rate)
    drift = audio.shape[1] - want
    if 0 < drift < slack:
        return audio[:, :want]
    if -slack < drift < 0:
        return np.pad(audio, [(0, 0), (0, -drift)], mode=pad_mode)
    return audio


def _make_padding_cut(mixed_cut: "MixedCut") -> PaddingCut:
    feat_geom = {}
    if mixed_cut.has_features:
        feat_geom = dict(
            num_frames=mixed_cut.num_frames, num_features=mixed_cut.num_features,
            frame_shift=mixed_cut.frame_shift)
    return PaddingCut(
        id=str(uuid4()), duration=mixed_cut.duration, sampling_rate=mixed_cut.sampling_rate,
        feat_value=LOG_EPSILON,
        num_samples=mixed_cut.num_samples if mixed_cut.has_recording else None,
        video=mixed_cut.video if mixed_cut.has_video else None, **feat_geom)


def _to_unmixed_cut(mixed_cut: "MixedCut", tracks: List[MixTrack]) -> Cut:
    if not tracks:
        return _make_padding_cut(mixed_cut)
    tracks = _ensure_explicit_snr_reference([fastcopy(t) for t in tracks])
    if all(t.snr is not None for t in tracks):
        # Every kept track is SNR-relative: carry the reference along, muted.
        _, ref = _get_snr_reference_track(mixed_cut)
        tracks.append(fastcopy(ref, is_snr_reference=True, mute=True))
    cut = MixedCut(id=str(uuid4()), tracks=tracks)
    if cut.duration < mixed_cut.duration:
        cut = cut.pad(duration=mixed_cut.duration, preserve_id=True)
    return cut
