"""
DataCut: the shared part of MonoCut and MultiCut, one Recording plus
supervisions and custom fields viewed through a [start, start+duration)
window (copied from ``lhotse_tpu/cut/data.py``), with the members the data
path uses: the ``Features`` manifest, ``compute_and_store_features``, the
``drop_*`` methods, ``fill_supervision``, the windowing builders
(``truncate``, ``extend_by``, ``pad``), the lazy waveform-domain builders
``resample``, ``perturb_speed``, ``perturb_tempo``, ``perturb_volume``,
``narrowband``, ``normalize_loudness`` and ``clip_amplitude``
(``reverb_rir`` is in :class:`~lhotse_tpu_torch.cut.mono.MonoCut`),
``dereverb_wpe`` (the host WPE transform), ``compress`` (the lossy-codec
round trip, optionally of custom ``Recording`` fields), ``move_to_memory``/
``drop_in_memory_data``, the path prefixes and the supervision merging that
``MonoCut.merge_supervisions`` and ``MultiCut.merge_supervisions`` use.
Every builder returns a modified manifest copy; no audio is touched until
``load_audio``/``load_features``. ``attach_tensor`` stores an array in
memory (raw or lilcom) under a custom name, and ``attach_image`` an image
(Pillow).
"""
from __future__ import annotations

import logging
from abc import ABCMeta, abstractmethod
from dataclasses import dataclass, field
from math import isclose
from pathlib import Path
from typing import Any, Callable, Dict, Generator, Iterable, List, Optional, Tuple, Union

import numpy as np

from lhotse_tpu_torch.array import Array, TemporalArray
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.custom import CustomFieldMixin
from lhotse_tpu_torch.cut.base import Cut
from lhotse_tpu_torch.features.base import FeatureExtractor, Features
from lhotse_tpu_torch.features.io import FeaturesWriter
from lhotse_tpu_torch.image import Image
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import (
    LOG_EPSILON, Pathlike, Seconds, TimeSpan, add_durations, asdict_nonull, compute_num_frames,
    compute_num_samples, fastcopy, is_module_available, measure_overlap, overlaps, overspans,
    perturb_num_samples, rich_exception_info, uuid4)

_DATA_MANIFEST_TYPES = (Recording, Features, Array, TemporalArray, Image)


@dataclass
class DataCut(Cut, CustomFieldMixin, metaclass=ABCMeta):
    """
    A cut backed by real stored data (contrast with MixedCut, which is an
    expression over other cuts).  Concrete subclasses: MonoCut, MultiCut.
    """

    id: str
    start: Seconds
    duration: Seconds
    channel: Union[int, List[int]]
    supervisions: List[SupervisionSegment] = field(default_factory=list)
    features: Optional[Features] = None
    recording: Optional[Recording] = None
    custom: Optional[Dict[str, Any]] = None

    # -- serialization ------------------------------------------------------------

    def to_dict(self) -> dict:
        d = asdict_nonull(self)
        if self.supervisions:
            # Delegate to SupervisionSegment.to_dict: plain dataclass recursion
            # would leave AlignmentItem NamedTuples embedded, which JSON
            # happens to dump as lists but YAML refuses to represent.
            d["supervisions"] = [s.to_dict() for s in self.supervisions]
        if self.has_recording:
            d["recording"] = self.recording.to_dict()
        for k, v in (self.custom or {}).items():
            if isinstance(v, Recording):
                d["custom"][k] = v.to_dict()
        d["type"] = type(self).__name__
        return d

    @staticmethod
    @abstractmethod
    def from_dict(data: dict) -> "DataCut":
        ...

    # -- what data is attached -------------------------------------------------------

    has_features = property(lambda self: self.features is not None)
    has_recording = property(lambda self: self.recording is not None)
    has_video = property(lambda self: self.recording is not None and self.recording.has_video)

    def iter_data(
        self,
    ) -> Generator[Tuple[str, Union[Recording, Features, Array, TemporalArray, Image]], None, None]:
        """(name, manifest) pairs for every piece of data this cut references."""
        if self.has_recording:
            yield "recording", self.recording
        if self.has_features:
            yield "features", self.features
        for k, v in (self.custom or {}).items():
            if isinstance(v, _DATA_MANIFEST_TYPES):
                yield k, v

    is_in_memory = property(lambda self: any(v.is_in_memory for _, v in self.iter_data()))

    def has(self, field: str) -> bool:
        builtin = {
            "recording": self.has_recording, "features": self.has_features, "video": self.has_video}
        if field in builtin:
            return builtin[field]
        return self.custom is not None and field in self.custom

    @property
    def recording_id(self) -> str:
        return self.recording.id if self.has_recording else self.features.recording_id

    # -- geometry ------------------------------------------------------------------

    @property
    def frame_shift(self) -> Optional[Seconds]:
        return self.features.frame_shift if self.has_features else None

    @property
    def num_frames(self) -> Optional[int]:
        if not self.has_features:
            return None
        return compute_num_frames(
            duration=self.duration, frame_shift=self.frame_shift, sampling_rate=self.sampling_rate)

    @property
    def num_samples(self) -> Optional[int]:
        if not self.has_recording:
            return None
        return compute_num_samples(self.duration, self.sampling_rate)

    num_features = property(lambda self: self.features.num_features if self.has_features else None)
    features_type = property(lambda self: self.features.type if self.has_features else None)

    @property
    @abstractmethod
    def num_channels(self) -> Optional[int]:
        ...

    @property
    def sampling_rate(self) -> int:
        source = self.features if self.has_features else self.recording
        return source.sampling_rate

    # -- data loading (concrete in Mono/MultiCut) ---------------------------------------

    @rich_exception_info
    @abstractmethod
    def load_features(self, **kwargs) -> Optional[np.ndarray]:
        ...

    @rich_exception_info
    @abstractmethod
    def load_audio(self, **kwargs) -> Optional[np.ndarray]:
        ...

    # -- data movement ------------------------------------------------------------------

    def move_to_memory(
        self, audio_format: str = "wav", load_audio: bool = True, load_features: bool = True,
        load_custom: bool = True) -> "Cut":
        """
        Pull this cut's window of data into the manifest itself (encoded
        bytes in memory).  Default audio format is wav; the reference uses
        flac — pass ``audio_format="flac"`` for byte-compatible output.
        """
        recording = self.recording
        if load_audio and self.has_recording:
            recording = recording.move_to_memory(
                channels=self.channel, offset=self.start, duration=self.duration,
                format=audio_format)
        features = self.features
        if load_features and self.has_features:
            features = features.move_to_memory(start=self.start, duration=self.duration)
        custom = self.custom
        if load_custom and custom is not None:
            def _pull(v):
                if isinstance(v, Array):
                    return v.move_to_memory()
                if isinstance(v, TemporalArray):
                    return v.move_to_memory(start=self.start, duration=self.duration)
                return v

            custom = {k: _pull(v) for k, v in custom.items()}
        # The in-memory payloads cover exactly this window: start resets to 0.
        return fastcopy(self, start=0.0, recording=recording, features=features, custom=custom)

    def drop_in_memory_data(self) -> "DataCut":
        """Swap in-memory payloads for Shar placeholders (metadata kept)."""
        from lhotse_tpu_torch.shar.utils import to_shar_placeholder

        def _strip(v):
            if isinstance(v, (Recording, Features, Array, TemporalArray)) and v.is_in_memory:
                return to_shar_placeholder(v)
            return v

        return fastcopy(
            self, recording=_strip(self.recording) if self.has_recording else None,
            features=_strip(self.features) if self.has_features else None,
            custom=None if self.custom is None else {k: _strip(v) for k, v in self.custom.items()})

    def attach_tensor(
        self, name: str, data: np.ndarray, frame_shift: Optional[Seconds] = None,
        temporal_dim: Optional[int] = None, compressed: bool = False) -> "Cut":
        """
        Store an ndarray in memory under ``name`` (retrievable later as
        ``cut.load_<name>()``); temporal arrays follow truncate/pad.
        """
        from lhotse_tpu_torch.features.io import MemoryLilcomWriter, MemoryRawWriter

        out = fastcopy(self, custom=dict(self.custom or {}))
        with (MemoryLilcomWriter() if compressed else MemoryRawWriter()) as writer:
            manifest = writer.store_array(
                key=out.id, value=np.asarray(data), frame_shift=frame_shift,
                temporal_dim=temporal_dim, start=out.start)
        setattr(out, name, manifest)
        return out

    def attach_image(self, key: str, path_or_object: Union[str, np.ndarray, bytes]) -> "DataCut":
        """Attach an image (file path, ndarray, or encoded bytes) under ``key``."""
        if not is_module_available("PIL"):
            raise AssertionError("Using images requires 'pip install pillow'.")
        from lhotse_tpu_torch.image.image import Image
        from lhotse_tpu_torch.image.io import PillowInMemoryWriter

        out = fastcopy(self, custom=dict(self.custom or {}))
        if isinstance(path_or_object, (str, Path)):
            import PIL.Image as PILImage

            with PILImage.open(path_or_object) as img:
                width, height = img.size
            p = Path(path_or_object)
            manifest = Image(
                storage_type="pillow_files", storage_path=str(p.parent), storage_key=str(p.name),
                width=width, height=height)
        else:
            with PillowInMemoryWriter() as writer:
                manifest = writer.store_image(key, path_or_object)
        out.custom[key] = manifest
        return out

    # -- detachment -----------------------------------------------------------------------

    def drop_features(self) -> "DataCut":
        if not self.has_recording:
            raise AssertionError(
                f"Cannot detach features from a DataCut with no Recording "
                f"(cut ID = {self.id})."
            )
        return fastcopy(self, features=None)

    def drop_recording(self) -> "DataCut":
        if not self.has_features:
            raise AssertionError(
                f"Cannot detach recording from a DataCut with no Features "
                f"(cut ID = {self.id})."
            )
        return fastcopy(self, recording=None)

    def drop_supervisions(self) -> "DataCut":
        return fastcopy(self, supervisions=[])

    def drop_alignments(self) -> "DataCut":
        return fastcopy(self, supervisions=[fastcopy(s, alignment={}) for s in self.supervisions])

    # -- supervision manipulation ------------------------------------------------------------

    def fill_supervision(self, add_empty: bool = True, shrink_ok: bool = False) -> "DataCut":
        """
        Stretch the (single) supervision to span the whole cut; with no
        supervision, add an empty one when ``add_empty``.  Shrinking an
        overhanging supervision requires ``shrink_ok=True``.
        """
        if not self.supervisions:
            if not add_empty:
                return self
            grown = [
                SupervisionSegment(
                    id=self.id,
                    recording_id=self.recording_id,
                    start=0,
                    duration=self.duration,
                    channel=self.channel,
                )
            ]
            return fastcopy(self, supervisions=grown)
        if len(self.supervisions) != 1:
            raise AssertionError(
                f"Cannot expand more than one supervision "
                f"(found {len(self.supervisions)})."
            )
        sup = self.supervisions[0]
        if isclose(sup.start, 0) and isclose(sup.duration, self.duration):
            return self
        if (sup.start < 0 or sup.end > self.end) and not shrink_ok:
            raise ValueError(
                f"Cannot shrink supervision (start={sup.start}, end={sup.end}) "
                f"to cut (start=0, duration={self.duration}) with shrink_ok=False. "
                f"A supervision exceeding a cut may indicate spoken content beyond "
                f"the cut's bounds; set shrink_ok=True to override."
            )
        return fastcopy(self, supervisions=[fastcopy(sup, start=0, duration=self.duration)])

    def map_supervisions(
        self, transform_fn: Callable[[SupervisionSegment], SupervisionSegment]) -> "DataCut":
        return fastcopy(self, supervisions=[s.map(transform_fn) for s in self.supervisions])

    def filter_supervisions(self, predicate: Callable[[SupervisionSegment], bool]) -> "DataCut":
        return fastcopy(self, supervisions=[s for s in self.supervisions if predicate(s)])

    @abstractmethod
    def merge_supervisions(
        self, merge_policy: str = "delimiter",
        custom_merge_fn: Optional[Callable[[str, Iterable[Any]], Any]] = None, **kwargs,
    ) -> "DataCut":
        ...

    # -- feature extraction --------------------------------------------------------------------

    def compute_and_store_features(
        self, extractor: FeatureExtractor, storage: FeaturesWriter, augment_fn=None, *args,
        **kwargs) -> "DataCut":
        """Extract + persist features for this window; returns the cut with
        the Features manifest attached."""
        manifest = extractor.extract_from_samples_and_store(
            samples=self.load_audio(), storage=storage, sampling_rate=self.sampling_rate,
            offset=self.start, channel=self.channel, augment_fn=augment_fn)
        return fastcopy(self, features=manifest)

    # -- windowing -------------------------------------------------------------------------------

    def truncate(
        self, *, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        keep_excessive_supervisions: bool = True, preserve_id: bool = False,
        _supervisions_index: Optional[Dict[str, Any]] = None) -> "DataCut":
        """
        View of ``[offset, offset+duration)`` within this cut (clamped to the
        cut's end).  Boundary-crossing supervisions are kept or dropped per
        ``keep_excessive_supervisions``.
        """
        if offset < 0:
            raise AssertionError(f"Offset for truncate must be non-negative (provided {offset}).")
        sr = self.sampling_rate
        new_start = max(add_durations(self.start, offset, sampling_rate=sr), 0)
        window = duration if duration is not None else self.duration
        # Quantize offset and window to the sample grid SEPARATELY before
        # differencing (reference cut/data.py:519-525): float-adding first
        # lands sums like 0.525+0.525 @22050 on .5-sample boundaries and
        # shifts the result by one sample vs the reference.
        until = add_durations(offset, window, sampling_rate=sr)
        new_duration = add_durations(until, -offset, sampling_rate=sr)
        if new_duration <= 0.0:
            raise AssertionError(f"new_duration={new_duration}")
        overhang = add_durations(
            new_start, new_duration, -self.start, -self.duration, sampling_rate=sr)
        if overhang > 0:
            new_duration = add_durations(new_duration, -overhang, sampling_rate=sr)
        if new_duration < 0.0:
            raise AssertionError(
                f"Truncation region [offset={offset}, offset+duration) lies "
                f"outside the cut (cut duration {self.duration}).")

        sups = self._truncated_supervisions(
            offset, new_duration, keep_excessive_supervisions, _supervisions_index)
        return fastcopy(
            self, id=self.id if preserve_id else str(uuid4()), start=new_start,
            duration=new_duration, supervisions=sorted(sups, key=lambda s: s.start))

    def _truncated_supervisions(
        self, offset, new_duration, keep_excessive, index) -> List[SupervisionSegment]:
        if index is None:
            accept = overlaps if keep_excessive else overspans
            span = TimeSpan(start=0, end=new_duration)
            shifted = (s.with_offset(-offset) for s in self.supervisions)
            return [s for s in shifted if accept(span, s)]
        window = TimeSpan(offset, offset + new_duration)
        out = []
        for s in index[self.id].overlap(begin=offset, end=offset + new_duration):
            if not keep_excessive:
                # Fully contained only (with a little float-epsilon slack).
                inside = (s.start >= offset - 1e-3 and s.end <= offset + new_duration + 1e-3)
                if not inside:
                    continue
            # Sub-1% overlaps are float-precision artifacts, not real overlap.
            if measure_overlap(s, window) > 0.01:
                out.append(s.with_offset(-offset))
        return out

    def extend_by(
        self, *, duration: Seconds, direction: str = "both", preserve_id: bool = False,
        pad_silence: bool = True) -> Cut:
        """
        Grow the window by ``duration`` seconds of *real* recording content
        per direction; where the recording runs out, optionally pad with
        silence.  Precomputed features/temporal arrays that no longer cover
        the window are detached with a warning.
        """
        if duration < 0:
            raise AssertionError(f"Duration must be non-negative (provided {duration}).")
        sr = self.sampling_rate
        new_start, new_end = self.start, self.end
        silence_left = silence_right = 0
        if direction in ("left", "both"):
            if pad_silence and self.start - duration < 0:
                silence_left = duration - self.start
            new_start = max(self.start - duration, 0)
        if direction in ("right", "both"):
            room = self.recording.duration - self.end
            if pad_silence and duration > room:
                silence_right = duration - room
            new_end = min(self.end + duration, self.recording.duration)
        new_duration = add_durations(new_end, -new_start, sampling_rate=sr)

        shift = add_durations(self.start, -new_start, sampling_rate=sr)
        sups = sorted((s.with_offset(shift) for s in self.supervisions), key=lambda s: s.start)

        def covers(attr) -> bool:
            lo = compute_num_frames(new_start, attr.frame_shift, sr)
            hi = compute_num_frames(new_end, attr.frame_shift, sr)
            attr_lo = compute_num_frames(attr.start, attr.frame_shift, sr)
            attr_hi = attr_lo + attr.num_frames
            return lo >= attr_lo - 1 and hi <= attr_hi + 1

        updates: Dict[str, Any] = {}
        if self.has_features and not covers(self.features):
            logging.warning(
                "Attempting to extend a cut beyond the range of pre-computed "
                "features; the feature manifest will be detached."
            )
            updates["features"] = None
        kept_custom = {}
        for name, value in (self.custom or {}).items():
            if isinstance(value, TemporalArray) and not covers(value):
                logging.warning(
                    f"Attempting to extend a cut beyond the range of pre-computed "
                    f"custom data '{name}'; the data will be detached."
                )
                kept_custom[name] = None
            else:
                kept_custom[name] = value

        out = fastcopy(
            self, id=self.id if preserve_id else str(uuid4()), start=new_start,
            duration=new_duration, supervisions=sups, custom=kept_custom, **updates)
        if silence_left > 0:
            out = out.pad(
                duration=out.duration + silence_left, direction="left", preserve_id=preserve_id)
        if silence_right > 0:
            out = out.pad(
                duration=out.duration + silence_right, direction="right", preserve_id=preserve_id)
        return out

    def pad(
        self, duration: Seconds = None, num_frames: int = None, num_samples: int = None,
        pad_feat_value: float = LOG_EPSILON, direction: str = "right", preserve_id: bool = False,
        pad_value_dict: Optional[Dict[str, Union[int, float]]] = None) -> Cut:
        """Pad to a target duration/frames/samples; see :func:`lhotse_tpu_torch.cut.set.pad`."""
        from lhotse_tpu_torch.cut.set import pad

        return pad(
            self, duration=duration, num_frames=num_frames, num_samples=num_samples,
            pad_feat_value=pad_feat_value, direction=direction, preserve_id=preserve_id,
            pad_value_dict=pad_value_dict)

    # -- waveform-domain lazy effects -------------------------------------------------------------
    # Shared plumbing: every effect needs a Recording, invalidates any
    # precomputed features, and renames the cut when affix_id is set.

    def _require_recording(self, op: str) -> None:
        if not self.has_recording:
            raise AssertionError(f"Cannot {op} on a DataCut without Recording.")

    def _invalidate_features(self, op: str) -> None:
        if self.has_features:
            logging.warning(
                f"Applying {op} on a DataCut with pre-computed features: the "
                f"feature manifest will be detached (waveform-domain op)."
            )
            self.features = None

    def resample(
        self, sampling_rate: int, affix_id: bool = False, recording_field: Optional[str] = None,
    ) -> "DataCut":
        """Lazy resample (of the main recording or a custom Recording field)."""
        self._require_recording("resample")
        recording, custom = self.recording, self.custom
        if recording_field is None:
            recording = recording.resample(sampling_rate)
        else:
            custom = dict(custom)
            custom[recording_field] = custom[recording_field].resample(sampling_rate)
        return fastcopy(
            self, id=f"{self.id}_rs{sampling_rate}" if affix_id else self.id, recording=recording,
            features=None, custom=custom)

    def _time_scaled(self, factor: float, suffix: str, affix_id: bool, op: str) -> "DataCut":
        """Common core of speed/tempo perturbation: everything on the cut's
        timeline scales by 1/factor via exact sample-count arithmetic."""
        self._require_recording(op)
        self._invalidate_features(op)
        sr = self.sampling_rate
        scaled_start = (perturb_num_samples(compute_num_samples(self.start, sr), factor) / sr)
        scaled_duration = perturb_num_samples(self.num_samples, factor) / sr
        if op == "perturb speed":
            rec = self.recording.perturb_speed(factor=factor, affix_id=affix_id)
            sups = [
                s.perturb_speed(factor=factor, sampling_rate=sr, affix_id=affix_id)
                for s in self.supervisions
            ]
        else:
            rec = self.recording.perturb_tempo(factor=factor, affix_id=affix_id)
            sups = [
                s.perturb_tempo(factor=factor, sampling_rate=sr, affix_id=affix_id)
                for s in self.supervisions
            ]
        return fastcopy(
            self, id=f"{self.id}{suffix}" if affix_id else self.id, recording=rec,
            supervisions=sups, start=scaled_start, duration=scaled_duration)

    def perturb_speed(self, factor: float, affix_id: bool = True) -> "DataCut":
        """Resample-based speed change (pitch shifts too)."""
        return self._time_scaled(factor, f"_sp{factor}", affix_id, "perturb speed")

    def perturb_tempo(self, factor: float, affix_id: bool = True) -> "DataCut":
        """Pitch-preserving tempo change."""
        return self._time_scaled(factor, f"_tp{factor}", affix_id, "perturb tempo")

    def perturb_volume(self, factor: float, affix_id: bool = True) -> "DataCut":
        """Scalar gain on the waveform."""
        self._require_recording("perturb volume")
        self._invalidate_features("perturb volume")
        return fastcopy(
            self, id=f"{self.id}_vp{factor}" if affix_id else self.id,
            recording=self.recording.perturb_volume(factor=factor, affix_id=affix_id),
            supervisions=[ s.perturb_volume(factor=factor, affix_id=affix_id) for s in self.supervisions ],
        )

    @abstractmethod
    def reverb_rir(
        self, rir_recording: Optional["Recording"] = None, normalize_output: bool = True,
        early_only: bool = False, affix_id: bool = True, rir_channels: List[int] = [0],
        room_rng_seed: Optional[int] = None, source_rng_seed: Optional[int] = None) -> "DataCut":
        ...

    def narrowband(
        self, codec: str, restore_orig_sr: bool = True, affix_id: bool = True) -> "DataCut":
        """Telephone-codec bandwidth reduction."""
        self._require_recording("apply narrowband")
        self._invalidate_features("narrowband")
        return fastcopy(
            self, id=f"{self.id}_nb_{codec}" if affix_id else self.id,
            recording=self.recording.narrowband( codec=codec, restore_orig_sr=restore_orig_sr, affix_id=affix_id ),
            supervisions=[ s.narrowband(codec=codec, affix_id=affix_id) for s in self.supervisions ],
        )

    def _renamed_supervisions(self, suffix: str, affix_id: bool) -> list:
        if not affix_id:
            return list(self.supervisions)
        return [
            fastcopy(s, id=f"{s.id}{suffix}", recording_id=f"{s.recording_id}{suffix}")
            for s in self.supervisions
        ]

    def normalize_loudness(self, target: float, affix_id: bool = False, **kwargs) -> "DataCut":
        """EBU R128 loudness normalization to ``target`` LUFS."""
        self._require_recording("normalize loudness")
        self._invalidate_features("loudness normalization")
        tag = f"_ln{target}"
        return fastcopy(
            self, id=f"{self.id}{tag}" if affix_id else self.id,
            recording=self.recording.normalize_loudness(target=target, affix_id=affix_id),
            supervisions=self._renamed_supervisions(tag, affix_id))

    def dereverb_wpe(self, affix_id: bool = True) -> "DataCut":
        """Weighted-prediction-error dereverberation."""
        self._require_recording("apply WPE")
        self._invalidate_features("WPE dereverberation")
        return fastcopy(
            self, id=f"{self.id}_wpe" if affix_id else self.id,
            recording=self.recording.dereverb_wpe(affix_id=affix_id),
            supervisions=self._renamed_supervisions("_wpe", affix_id))

    def clip_amplitude(
        self, hard: bool = False, gain_db: float = 0.0, normalize: bool = True,
        oversampling: Optional[int] = 2, affix_id: bool = True) -> "DataCut":
        """Hard/soft amplitude clipping (audio path only)."""
        self._require_recording("apply clipping")
        if self.has_features:
            logging.warning(
                "Applying clipping on a DataCut with pre-computed features: the "
                "clipping affects only the audio path."
            )
        return fastcopy(
            self, id=f"{self.id}_cl{gain_db}" if affix_id else self.id,
            recording=self.recording.clip_amplitude( hard=hard, gain_db=gain_db, normalize=normalize, oversampling=oversampling, affix_id=affix_id, ),
        )

    def compress(
        self, codec: str = "opus", compression_level: float = 0.99,
        compress_custom_fields: bool = False) -> "DataCut":
        """Lossy-codec round-trip on the recording (optionally also on custom
        Recording fields)."""
        self._require_recording("compress")
        custom = self.custom
        if compress_custom_fields and isinstance(custom, dict):
            custom = {
                k: v.compress(codec, compression_level) if isinstance(v, Recording) else v for k,
                v in custom.items()}
        return fastcopy(
            self, recording=self.recording.compress(codec, compression_level), custom=custom)

    # -- path remapping --------------------------------------------------------------------------

    def with_features_path_prefix(self, path: Pathlike) -> "DataCut":
        if not self.has_features:
            return self
        return fastcopy(self, features=self.features.with_path_prefix(path))

    def with_recording_path_prefix(self, path: Pathlike) -> "DataCut":
        if not self.has_recording:
            return self
        return fastcopy(self, recording=self.recording.with_path_prefix(path))


# -- supervision merging (shared by MonoCut / MultiCut) ------------------------------------------


def make_supervision_mergers(merge_policy: str, custom_merge_fn):
    """(field-joiner, custom-field joiner) for merge_supervisions()."""
    from functools import partial

    from lhotse_tpu_torch.utils import merge_items_with_delimiter

    join = partial(
        merge_items_with_delimiter, delimiter="#", return_first=(merge_policy == "keep_first"))
    if custom_merge_fn is not None:
        return join, custom_merge_fn
    return join, (lambda key, values: join(map(str, values)))


def has_overlapping_texts(sups) -> bool:
    """Any two start-adjacent supervisions overlap while texts exist?"""
    from lhotse_tpu_torch.utils import overlaps

    touching = any(overlaps(a, b) for a, b in zip(sups, sups[1:]))
    return touching and any(s.text is not None for s in sups)


def merge_segment_group(
    sups, *, sampling_rate: int, channel, join, join_custom, group_end=None) -> SupervisionSegment:
    """
    Collapse a start-sorted supervision group into one spanning segment:
    texts joined with whitespace, other string fields via ``join``,
    alignments concatenated, customs merged per key via ``join_custom``.

    Deviation from the reference: the merged end is ``max(s.end)`` over the
    group, not the end of the last-starting segment (reference
    cut/mono.py:309 truncates the span when a nested/earlier segment
    outlasts the last-starting one). See docs/migrating-from-lhotse.md.
    """
    from functools import reduce
    from operator import add as _add

    from lhotse_tpu_torch.utils import add_durations

    begin = sups[0].start
    finish = group_end if group_end is not None else max(s.end for s in sups)
    custom_keys = {k for s in sups if s.custom is not None for k in s.custom}
    ali_keys = {k for s in sups if s.alignment is not None for k in s.alignment}
    return SupervisionSegment(
        id=join(s.id for s in sups), recording_id=sups[0].recording_id, start=begin,
        duration=add_durations(finish, -begin, sampling_rate=sampling_rate), channel=channel,
        text=" ".join(s.text for s in sups if s.text),
        speaker=join(s.speaker for s in sups if s.speaker),
        language=join(s.language for s in sups if s.language),
        gender=join(s.gender for s in sups if s.gender),
        custom={ k: join_custom( k, (s.custom[k] for s in sups if s.custom is not None and k in s.custom) ) for k in custom_keys },
        alignment={ k: reduce( _add, (s.alignment[k] for s in sups if s.alignment is not None and k in s.alignment), ) for k in ali_keys },
    )
