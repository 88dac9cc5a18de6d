"""
The Recording manifest: where audio bytes live and how to decode them
(copied from ``lhotse_tpu/audio/recording.py``). ``load_audio`` reads the
requested (channels, offset, duration) window of the sources through the
decoded-audio LRU of :mod:`lhotse_tpu_torch.caching`, then runs the
recording's chain of lazily applied transforms (speed, tempo, volume,
reverb, resampling, WPE) with *reverse timestamp propagation*: the window is
mapped back through every transform so only the needed source samples are
read. A recording of several sources (one per channel, as a microphone
array's files) reads each source's window and stacks them.

The post-transform window cache keys each window by the identity of every
source it reads (path or bytes hash), not by ``Recording.id``: two
recordings that share an id but not their audio get their own windows. The
JAX package keys it by the id.

A channel subset of a recording whose chain mixes or fans out channels
(``DereverbWPE``, a multi-channel RIR) is read as the whole recording, run
through the chain, and then picked: the transform sees every channel. The
JAX package runs the chain on the subset alone.

Left out: video, which raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from io import BytesIO
from decimal import ROUND_HALF_UP
from math import ceil, isclose
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from lhotse_tpu_torch.audio.backend import info, save_audio
from lhotse_tpu_torch.audio.source import AudioSource
from lhotse_tpu_torch.audio.utils import (
    AudioLoadingError, DurationMismatchError, get_audio_duration_mismatch_tolerance)
from lhotse_tpu_torch.augmentation import (
    AudioTransform, Clipping, Compress, DereverbWPE, LoudnessNormalization, Narrowband,
    Resample, ReverbWithImpulseResponse, Speed, Tempo, Volume)
from lhotse_tpu_torch.utils import (
    Channels, Pathlike, Seconds, asdict_nonull, compute_num_samples, fastcopy, ifnone,
    not_ported, perturb_num_samples, rich_exception_info)


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
    transforms: Optional[List[Union[AudioTransform, Dict]]] = None

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
    is_placeholder = property(
        lambda self: self._matching_source(lambda s: s.type == "shar") is not None
    )
    num_channels = property(lambda self: len(self.channel_ids))

    @property
    def source_format(self) -> str:
        formats = {s.format for s in self.sources}
        if len(formats) != 1:
            raise NotImplementedError(
                "Sources have different formats; resolving to a single format "
                "is not implemented."
            )
        return formats.pop()

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
    def from_bytes(data: bytes, recording_id: str) -> "Recording":
        """Like :meth:`from_file` for encoded bytes, attached to the manifest."""
        meta = info(BytesIO(data))
        return Recording(
            id=recording_id, sampling_rate=meta.samplerate, num_samples=meta.frames,
            duration=meta.duration,
            sources=[AudioSource(type="memory", channels=list(range(meta.channels)), source=data)])

    @staticmethod
    def from_dict(data: dict) -> "Recording":
        raw_sources = data.pop("sources")
        transforms = data.pop("transforms", None)
        if transforms is not None:
            transforms = [AudioTransform.from_dict(t) for t in transforms]
        return Recording(
            sources=[AudioSource.from_dict(s) for s in raw_sources], transforms=transforms, **data)

    def to_dict(self) -> dict:
        d = asdict_nonull(self)
        if self.transforms is not None:
            d["transforms"] = [t if isinstance(t, dict) else t.to_dict() for t in self.transforms]
        return d

    def to_cut(self):
        """A MonoCut/MultiCut covering this entire recording."""
        from lhotse_tpu_torch.cut import MonoCut, MultiCut

        mono = self.num_channels == 1
        return (MonoCut if mono else MultiCut)(
            id=self.id, start=0.0, duration=self.duration,
            channel=self.channel_ids[0] if mono else self.channel_ids, recording=self)

    def move_to_memory(
        self, channels: Optional[Channels] = None, offset: Seconds = None,
        duration: Optional[Seconds] = None, format: Optional[str] = None) -> "Recording":
        """
        Return a copy whose sources hold the encoded bytes in memory.  With no
        subset requested the original encoded bytes are attached verbatim;
        otherwise audio is decoded, windowed, and re-encoded (wav by default).
        """
        if all(src.type == "memory" for src in self.sources):
            return self

        want_channels = [channels] if isinstance(channels, int) else channels
        whole_thing = (
            (want_channels is None or want_channels == self.channel_ids)
            and (offset is None or isclose(offset, 0.0))
            and (duration is None or isclose(duration, self.duration))
        )
        if whole_thing:
            return fastcopy(
                self,
                sources=[ AudioSource( type="memory", channels=src.channels, source=Path(src.source).read_bytes(), ) for src in self.sources ],
            )

        audio = self.load_audio(channels=channels, offset=ifnone(offset, 0), duration=duration)
        buf = BytesIO()
        save_audio(buf, audio, self.sampling_rate, format=ifnone(format, "wav"))
        return Recording(
            id=self.id,
            sources=[ AudioSource( type="memory", channels=ifnone(want_channels, self.channel_ids), source=buf.getvalue(), ) ],
            sampling_rate=self.sampling_rate, num_samples=audio.shape[1],
            duration=ifnone(duration, self.duration))

    # -- loading -----------------------------------------------------------------

    @rich_exception_info
    def load_audio(
        self, channels: Optional[Channels] = None, offset: Seconds = 0.0,
        duration: Optional[Seconds] = None) -> np.ndarray:
        """
        Decode samples for the requested (channels, offset, duration) window,
        then apply the transform chain.  The window is first propagated
        backwards through the chain so the source read covers exactly the
        samples the transforms need.

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
        if self.has_video:
            raise not_ported(f"Video recordings (recording {self.id!r})")
        chain = [
            t if isinstance(t, AudioTransform) else AudioTransform.from_dict(t)
            for t in self.transforms or []
        ]
        if (
            channels is not None
            and wanted != frozenset(self.channel_ids)
            and not all(t.channel_wise for t in chain)
        ):
            whole = self.load_audio(offset=offset, duration=requested_duration)
            return whole[[row for row, cid in enumerate(self._rows(whole)) if cid in wanted]]

        # Map the requested window back through the chain (last to first).
        src_offset, src_duration = offset, duration
        for t in reversed(chain):
            src_offset, src_duration = t.reverse_timestamps(
                offset=src_offset, duration=src_duration, sampling_rate=self.sampling_rate)

        from lhotse_tpu_torch.tracing import add_work, trace_span

        # Post-transform window memoization for deterministic chains: warm
        # epochs skip both the decode and the DSP chain. Hits return a copy
        # of the very array a cold call produced for the same request.
        xkey = self._transformed_cache_key(chain, channels, wanted, offset, requested_duration)
        if xkey is not None:
            from lhotse_tpu_torch.caching import DecodedAudioCache

            entry = DecodedAudioCache.try_cache(xkey)
            if entry is not None:
                return entry[0].copy()
            if not DecodedAudioCache.worth_caching(xkey):
                xkey = None  # first sighting: window-decode directly

        with trace_span("audio.decode"):
            audio = self._stack_audio_channels(
                self._read_sources(wanted, src_offset, src_duration)
            )
            add_work(audio.shape[1] / self.sampling_rate)
        if chain:
            with trace_span("audio.transforms"):
                for t in chain:
                    audio = t(audio, self.sampling_rate)
                add_work(audio.shape[1] / self.sampling_rate)

        audio = assert_and_maybe_fix_num_samples(
            audio, offset=offset, duration=requested_duration, recording=self)
        if xkey is not None:
            from lhotse_tpu_torch.caching import DecodedAudioCache

            DecodedAudioCache.add_to_cache(xkey, audio, self.sampling_rate)
        return audio

    def _rows(self, audio: np.ndarray) -> List[int]:
        """The channel id of each row of ``audio``, all of this recording's
        channels after its chain: the sources' channels in source order, or,
        where the chain fanned them out, ``channel_ids``."""
        rows = [cid for src in self.sources for cid in src.channels]
        return rows if len(rows) == audio.shape[0] else list(self.channel_ids)

    def _transformed_cache_key(self, chain, channels, wanted, offset, requested_duration):
        """Stable LRU key for a post-transform audio window, or None when the
        request is not memoizable (no transforms — the source-level cache in
        :meth:`_read_sources` already covers plain decodes — nondeterministic
        chain, a source without a stable identity, unbounded size, or caching
        disabled). The key names every source by its identity (its path or
        the hash of its bytes), never by ``self.id``."""
        from lhotse_tpu_torch.caching import DecodedAudioCache

        if (
            not chain
            or not DecodedAudioCache.enabled()
            or self.num_samples > DecodedAudioCache.max_item_samples
            or not all(t.is_deterministic for t in chain)
        ):
            return None
        sources = tuple(
            (tuple(src.channels), self._decoded_cache_key(src, idx))
            for idx, src in enumerate(self.sources))
        if any(key is None for _, key in sources):
            return None
        import hashlib

        tlist = [
            t if isinstance(t, dict) else t.to_dict() for t in self.transforms or []
        ]
        fp = hashlib.blake2b(repr(tlist).encode(), digest_size=12).digest()
        return (
            "xformed",
            sources,
            self.sampling_rate,
            fp,
            ("all",) if channels is None else tuple(sorted(wanted)),
            compute_num_samples(offset, self.sampling_rate) if offset else 0,
            (
                -1
                if requested_duration is None
                else compute_num_samples(requested_duration, self.sampling_rate)
            ),
        )

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

    def with_path_prefix(self, path: Pathlike) -> "Recording":
        return fastcopy(self, sources=[s.with_path_prefix(path) for s in self.sources])

    def copy_with(self, **kwargs) -> "Recording":
        return fastcopy(self, **kwargs)

    # -- lazy transform builders ---------------------------------------------------
    # Each returns a copy with one more entry on the transform chain; geometry
    # fields (duration / num_samples / sampling_rate / channels) are updated
    # whenever the transform changes them.

    def _chain_plus(self, *new_transforms) -> list:
        chain = list(self.transforms) if self.transforms is not None else []
        chain.extend(new_transforms)
        return chain

    def _affixed(self, affix_id: bool, suffix: str) -> str:
        return f"{self.id}{suffix}" if affix_id else self.id

    def perturb_speed(self, factor: float, affix_id: bool = True) -> "Recording":
        """Resample-based speed change: shifts both pitch and duration."""
        n = perturb_num_samples(self.num_samples, factor)
        return fastcopy(
            self, id=self._affixed(affix_id, f"_sp{factor}"), num_samples=n,
            duration=n / self.sampling_rate, transforms=self._chain_plus(Speed(factor=factor)))

    def perturb_tempo(self, factor: float, affix_id: bool = True) -> "Recording":
        """WSOLA tempo change: shifts duration, preserves pitch."""
        n = perturb_num_samples(self.num_samples, factor)
        return fastcopy(
            self, id=self._affixed(affix_id, f"_tp{factor}"), num_samples=n,
            duration=n / self.sampling_rate, transforms=self._chain_plus(Tempo(factor=factor)))

    def perturb_volume(self, factor: float, affix_id: bool = True) -> "Recording":
        """Scalar gain."""
        return fastcopy(
            self, id=self._affixed(affix_id, f"_vp{factor}"),
            transforms=self._chain_plus(Volume(factor=factor)))

    def reverb_rir(
        self, rir_recording: Optional["Recording"] = None, normalize_output: bool = True,
        early_only: bool = False, affix_id: bool = True,
        rir_channels: Optional[Sequence[int]] = None, room_rng_seed: Optional[int] = None,
        source_rng_seed: Optional[int] = None) -> "Recording":
        """
        Convolve with a real or synthetic (FRA-RIR) impulse response.  A mono
        recording convolved with a multi-channel RIR becomes multi-channel.
        """
        if rir_recording is not None and rir_recording.sampling_rate != self.sampling_rate:
            raise AssertionError(
                f"Sampling rate mismatch between RIR vs recording: "
                f"{rir_recording.sampling_rate} vs {self.sampling_rate}."
            )
        fans_out = (self.num_channels == 1 and rir_channels is not None and len(rir_channels) > 1)
        out_channels = list(range(len(rir_channels))) if fans_out else self.channel_ids

        synth = None
        if rir_recording is None:
            from lhotse_tpu_torch.augmentation.utils import FastRandomRIRGenerator

            synth = FastRandomRIRGenerator(
                sr=self.sampling_rate, room_seed=room_rng_seed, source_seed=source_rng_seed)
        effect = ReverbWithImpulseResponse(
            rir=rir_recording, normalize_output=normalize_output, early_only=early_only,
            rir_channels=rir_channels if rir_channels is not None else [0], rir_generator=synth)
        return fastcopy(
            self, id=self._affixed(affix_id, "_rvb"), channel_ids=out_channels,
            transforms=self._chain_plus(effect))

    def resample(self, sampling_rate: int) -> "Recording":
        """Sinc-kernel resampling to a new rate."""
        if sampling_rate == self.sampling_rate:
            return fastcopy(self)
        n = compute_num_samples(self.duration, sampling_rate, rounding=ROUND_HALF_UP)
        return fastcopy(
            self, duration=n / sampling_rate, num_samples=n, sampling_rate=sampling_rate,
            transforms=self._chain_plus( Resample( source_sampling_rate=self.sampling_rate, target_sampling_rate=sampling_rate, ) ),
        )

    def narrowband(
        self, codec: str, restore_orig_sr: bool = True, affix_id: bool = True) -> "Recording":
        """Telephone-codec bandwidth reduction (optionally staying at 8 kHz)."""
        out_sr = self.sampling_rate if restore_orig_sr else 8000
        return fastcopy(
            self, id=self._affixed(affix_id, f"_nb_{codec}"),
            num_samples=compute_num_samples( self.duration, out_sr, rounding=ROUND_HALF_UP ),
            sampling_rate=out_sr,
            transforms=self._chain_plus( Narrowband( codec=codec, source_sampling_rate=self.sampling_rate, restore_orig_sr=restore_orig_sr, ).to_dict() ),
        )

    def normalize_loudness(self, target: float, affix_id: bool = False) -> "Recording":
        """EBU R128 loudness normalization to ``target`` dB LUFS."""
        return fastcopy(
            self, id=self._affixed(affix_id, f"_ln{target}"),
            transforms=self._chain_plus(LoudnessNormalization(target=target)))

    def dereverb_wpe(self, affix_id: bool = True) -> "Recording":
        """Weighted prediction error dereverberation."""
        return fastcopy(
            self, id=self._affixed(affix_id, "_wpe"), transforms=self._chain_plus(DereverbWPE()))

    def clip_amplitude(
        self, hard: bool = False, gain_db: float = 0.0, normalize: bool = True,
        oversampling: Optional[int] = 4, affix_id: bool = False) -> "Recording":
        """Hard/soft clipping, optionally sandwiched between up/down-resamples."""
        clip = Clipping(hard, gain_db, normalize)
        if oversampling is None:
            added = (clip,)
        else:
            hi_sr = self.sampling_rate * oversampling
            added = (
                Resample( source_sampling_rate=self.sampling_rate, target_sampling_rate=hi_sr ),
                clip,
                Resample( source_sampling_rate=hi_sr, target_sampling_rate=self.sampling_rate ))
        return fastcopy(
            self, id=self._affixed(affix_id, f"_cl{gain_db:.1f}"),
            transforms=self._chain_plus(*added))

    def compress(self, codec: str = "opus", compression_level: float = 0.99) -> "Recording":
        """Round-trip through a lossy codec (artifact simulation)."""
        if codec not in Compress.supported_codecs:
            raise ValueError(
                f"Invalid codec: {codec}. Must be one of: "
                f"{', '.join(Compress.supported_codecs)}"
            )
        if not 0.0 <= compression_level <= 1.0:
            raise ValueError(
                f"Compression level must be between 0.0 and 1.0, got {compression_level}"
            )
        squeeze = Compress(codec=codec, compression_level=compression_level)
        if codec == "gsm" and self.sampling_rate != 8000:
            # GSM is defined at 8 kHz only; bracket it with resamples.
            added = (
                Resample( source_sampling_rate=self.sampling_rate, target_sampling_rate=8000 ),
                squeeze,
                Resample( source_sampling_rate=8000, target_sampling_rate=self.sampling_rate ))
        else:
            added = (squeeze,)
        return fastcopy(self, transforms=self._chain_plus(*added))


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
