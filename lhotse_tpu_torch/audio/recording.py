"""
The Recording manifest: where audio bytes live and how to decode them
(copied from ``lhotse_tpu/audio/recording.py``). ``load_audio`` reads the
requested (channels, offset, duration) window of the sources through the
decoded-audio LRU of :mod:`lhotse_tpu_torch.caching`.

Left out: the host transform chain (``perturb_speed``, ``reverb_rir``,
``resample`` and the rest): on the port's path the device does the speed
perturb and the reverb. A manifest whose recording carries ``transforms``
raises ``NotImplementedError`` when it is read; so do video and
``MultiCut`` (multi-channel) recordings.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import ceil, isclose
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from lhotse_tpu_torch.audio.backend import info
from lhotse_tpu_torch.audio.source import AudioSource
from lhotse_tpu_torch.audio.utils import (
    AudioLoadingError, DurationMismatchError, get_audio_duration_mismatch_tolerance)
from lhotse_tpu_torch.utils import (
    Channels, Pathlike, Seconds, asdict_nonull, compute_num_samples, fastcopy, not_ported,
    rich_exception_info)


class SetContainingAnything:
    """Stand-in for "all channels requested" in channel-filtering logic."""

    def __contains__(self, item):
        return True

    def intersection(self, iterable):
        return True


@dataclass
class Recording:
    """
    Manifest of one recording session — anything from a two-second utterance
    to an hour of multi-channel far-field audio (which Cuts then partition
    for training).  Audio itself is loaded on demand via ``load_audio``.
    """

    id: str
    sources: List[AudioSource]
    sampling_rate: int
    num_samples: int
    duration: Seconds
    channel_ids: Optional[List[int]] = None
    transforms: Optional[List[Dict]] = None

    def __post_init__(self):
        if self.channel_ids is None:
            self.channel_ids = sorted(cid for src in self.sources for cid in src.channels)
        if sum(src.has_video for src in self.sources) > 1:
            raise AssertionError("More than one video stream per recording is not supported.")

    # -- introspection -----------------------------------------------------------

    def _matching_source(self, pred) -> Optional[AudioSource]:
        return next(filter(pred, self.sources), None)

    _video_source = property(lambda self: self._matching_source(lambda s: s.has_video))
    video = property(
        lambda self: getattr(self._video_source, "video", None),
        doc="VideoInfo of the video stream, if this recording has one.")
    has_video = property(lambda self: self._video_source is not None)
    is_in_memory = property(
        lambda self: self._matching_source(lambda s: s.type == "memory") is not None
    )
    num_channels = property(lambda self: len(self.channel_ids))

    # -- construction ------------------------------------------------------------

    @staticmethod
    def from_file(
        path: Pathlike, recording_id: Optional[Union[str, Callable[[Path], str]]] = None,
        relative_path_depth: Optional[int] = None, force_opus_sampling_rate: Optional[int] = None,
        force_read_audio: bool = False) -> "Recording":
        """Header-read a file into a Recording (no audio decoding)."""
        path = Path(path)
        if recording_id is None:
            rid = path.stem
        elif callable(recording_id):
            rid = recording_id(path)
        else:
            rid = recording_id
        meta = info(
            path, force_opus_sampling_rate=force_opus_sampling_rate,
            force_read_audio=force_read_audio)
        if meta.video is not None:
            duration = meta.video.duration
            n = compute_num_samples(duration, meta.samplerate)
        else:
            duration, n = meta.duration, meta.frames
        if relative_path_depth is not None and relative_path_depth > 0:
            stored_path = "/".join(path.parts[-relative_path_depth:])
        else:
            stored_path = str(path)
        src = AudioSource(
            type="file", channels=list(range(meta.channels)), source=stored_path, video=meta.video)
        return Recording(
            id=rid, sampling_rate=meta.samplerate, num_samples=n, duration=duration, sources=[src])

    @staticmethod
    def from_dict(data: dict) -> "Recording":
        raw_sources = data.pop("sources")
        transforms = data.pop("transforms", None)
        if transforms is not None:
            raise not_ported(f"Recording transforms (recording {data.get('id')!r})")
        return Recording(
            sources=[AudioSource.from_dict(s) for s in raw_sources], transforms=transforms, **data)

    def to_dict(self) -> dict:
        d = asdict_nonull(self)
        if self.transforms is not None:
            d["transforms"] = [t if isinstance(t, dict) else t.to_dict() for t in self.transforms]
        return d

    def to_cut(self):
        """A MonoCut/MultiCut covering this entire recording."""
        from lhotse_tpu_torch.cut import MonoCut

        mono = self.num_channels == 1
        if not mono:
            raise not_ported("MultiCut (multi-channel recordings)")
        return MonoCut(
            id=self.id, start=0.0, duration=self.duration,
            channel=self.channel_ids[0] if mono else self.channel_ids, recording=self)

    # -- loading -----------------------------------------------------------------

    @rich_exception_info
    def load_audio(
        self, channels: Optional[Channels] = None, offset: Seconds = 0.0,
        duration: Optional[Seconds] = None) -> np.ndarray:
        """
        Decode samples for the requested (channels, offset, duration) window.

        :return: float32 array shaped ``(num_channels, num_samples)``.
        """
        if offset > self.duration:
            raise AssertionError(
                f"Cannot load audio because the Recording's duration {self.duration}s "
                f"is smaller than the requested offset {offset}s."
            )
        # "Almost the whole recording" reads everything: sub-millisecond
        # windows would otherwise trip the sample-count check.
        requested_duration = duration
        if duration is not None and isclose(duration, self.duration, abs_tol=1e-3):
            duration = None

        wanted = self._channel_selector(channels)
        if self.transforms:
            raise not_ported(f"Recording transforms (recording {self.id!r})")
        if self.has_video:
            raise not_ported(f"Video recordings (recording {self.id!r})")
        src_offset, src_duration = offset, duration

        from lhotse_tpu_torch.tracing import add_work, trace_span

        with trace_span("audio.decode"):
            audio = self._stack_audio_channels(
                self._read_sources(wanted, src_offset, src_duration)
            )
            add_work(audio.shape[1] / self.sampling_rate)
        return assert_and_maybe_fix_num_samples(
            audio, offset=offset, duration=requested_duration, recording=self)

    def _channel_selector(self, channels: Optional[Channels]):
        if channels is None:
            return SetContainingAnything()
        wanted = frozenset([channels] if isinstance(channels, int) else channels)
        available = frozenset(self.channel_ids)
        if not wanted.issubset(available):
            raise AssertionError(
                "Requested to load audio from a channel that does not exist in "
                f"the recording: (recording channels: {available} -- requested "
                f"channels: {wanted})"
            )
        return wanted

    def _read_sources(self, wanted, offset, duration) -> List[np.ndarray]:
        from lhotse_tpu_torch.caching import DecodedAudioCache

        use_cache = (
            DecodedAudioCache.enabled()
            and self.num_samples <= DecodedAudioCache.max_item_samples
            and not self.has_video
        )
        blocks = []
        for idx, src in enumerate(self.sources):
            if not wanted.intersection(src.channels):
                continue
            block = (
                self._load_source_cached(src, idx, offset, duration)
                if use_cache
                else None
            )
            if block is None:
                block = src.load_audio(
                    offset=offset, duration=duration,
                    force_opus_sampling_rate=self.sampling_rate)
            unwanted_rows = [row for row, cid in enumerate(src.channels) if cid not in wanted]
            if unwanted_rows:
                block = np.delete(block, unwanted_rows, axis=0)
            blocks.append(block)
        return blocks

    def _decoded_cache_key(self, src, idx: int):
        """Stable identity for one audio source's decoded samples, or None
        when the source kind has no safe identity."""
        if src.type in ("file", "url") and isinstance(src.source, str):
            return ("path", src.source)
        if src.type == "memory" and isinstance(src.source, bytes):
            import hashlib

            return ("mem", hashlib.blake2b(src.source, digest_size=16).digest())
        return None

    def _load_source_cached(self, src, idx: int, offset, duration):
        """
        Serve a window of ``src`` from the decoded-audio LRU: the full source
        is decoded once, then every window is a slice (backends convert the
        window with the same ``compute_num_samples`` rounding, so slicing is
        sample-exact). Returns None when the source is uncacheable.
        """
        from lhotse_tpu_torch.caching import DecodedAudioCache

        key = self._decoded_cache_key(src, idx)
        if key is None:
            return None
        entry = DecodedAudioCache.try_cache(key)
        if entry is None:
            # Only sources seen before are worth a full decode + cache copy;
            # one-shot recordings window-decode directly.
            if not DecodedAudioCache.worth_caching(key):
                return None
            full = src.load_audio(
                offset=0.0, duration=None,
                force_opus_sampling_rate=self.sampling_rate)
            full = np.atleast_2d(np.asarray(full, dtype=np.float32))
            DecodedAudioCache.add_to_cache(key, full, self.sampling_rate)
            samples = full
        else:
            samples, _ = entry
        begin = compute_num_samples(offset, self.sampling_rate) if offset else 0
        if duration is None:
            return samples[:, begin:].copy()
        num = compute_num_samples(duration, self.sampling_rate)
        return samples[:, begin : begin + num].copy()

    def _stack_audio_channels(self, blocks: List[np.ndarray]) -> np.ndarray:
        """Stack per-source blocks, padding length skew within tolerance."""
        if len(blocks) <= 1:
            return np.vstack(blocks)
        slack = int(
            compute_num_samples(
                get_audio_duration_mismatch_tolerance(),
                sampling_rate=self.sampling_rate,
            )
        )
        blocks = [b[None, :] if b.ndim == 1 else b for b in blocks]
        longest = max(b.shape[1] for b in blocks)
        padded = []
        for b in blocks:
            short_by = longest - b.shape[1]
            if short_by > slack:
                raise DurationMismatchError(
                    f"The mismatch between the number of samples in the different "
                    f"channels of recording {self.id} exceeds the allowed tolerance "
                    f"{get_audio_duration_mismatch_tolerance()}."
                )
            padded.append(np.pad(b, ((0, 0), (0, short_by)), "constant"))
        return np.concatenate(padded, axis=0)

    # -- copies ------------------------------------------------------------------

    def copy_with(self, **kwargs) -> "Recording":
        return fastcopy(self, **kwargs)


def assert_and_maybe_fix_num_samples(
    audio: np.ndarray, offset: Seconds, duration: Optional[Seconds], recording: Recording,
    tolerance: Optional[Seconds] = None, pad_mode: str = "reflect") -> np.ndarray:
    """
    Reconcile the decoded sample count with the declared one: transform
    chains and codecs can be off by a few samples.  Pad or trim within
    ``tolerance`` seconds; anything larger is a real corruption and raises.
    """
    if tolerance is None:
        tolerance = get_audio_duration_mismatch_tolerance()
    want = compute_num_samples(
        duration=duration if duration is not None else recording.duration - offset,
        sampling_rate=recording.sampling_rate)
    short_by = want - audio.shape[1]
    if short_by == 0:
        return audio
    slack = int(ceil(tolerance * recording.sampling_rate))
    if 0 < short_by <= slack:
        return np.pad(audio, ((0, 0), (0, short_by)), mode=pad_mode)
    if -slack <= short_by < 0:
        return audio[:, :short_by]
    raise AudioLoadingError(
        "The number of declared samples in the recording diverged from the one "
        f"obtained when loading audio (offset={offset}, duration={duration}). "
        f"diff={short_by}, audio.shape={audio.shape}, recording={recording}"
    )
