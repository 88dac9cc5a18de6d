"""
AudioSource: where a recording's bytes are (copied from
``lhotse_tpu/audio/source.py``), for the ``file``, ``command`` (a shell
pipe whose standard output is the encoded audio, as a Kaldi ``wav.scp``
line ending in ``|`` gives), ``memory`` and ``shar_ptr`` (a byte range in a
Shar tar shard, read with
:func:`lhotse_tpu_torch.shar.lazy_pointer.read_payload`) source types. A
``command`` source runs its pipe on every read unless
:class:`~lhotse_tpu_torch.caching.AudioCache` is on, and raises with the
pipe's stderr when the pipe exits non-zero. A ``shar`` placeholder that was
never filled raises ``RuntimeError``; ``url`` sources, and video, raise
``NotImplementedError``.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from io import BytesIO, FileIO
from pathlib import Path
from subprocess import PIPE, run
from typing import List, Optional, Union

import numpy as np

from lhotse_tpu_torch.audio.backend import read_audio
from lhotse_tpu_torch.audio.utils import DurationMismatchError, VideoInfo, get_audio_duration_mismatch_tolerance
from lhotse_tpu_torch.caching import AudioCache
from lhotse_tpu_torch.utils import Pathlike, Seconds, asdict_nonull, fastcopy, not_ported

PathOrFilelike = Union[str, BytesIO, FileIO]


@dataclass
class AudioSource:
    """AudioSource represents audio data that can be retrieved from somewhere."""

    type: str
    """
    The type of audio source. Supported types are:
    - 'file' (most standard audio encodings, possibly multi-channel)
    - 'command' [unix pipe] (most standard audio encodings, possibly multi-channel)
    - 'url' (any URL type supported by the optional "smart_open" package)
    - 'memory' (any format, read from a binary string attached to the 'source' member)
    - 'shar' (placeholder filled later when using the Shar data format)
    - 'shar_ptr' (lazy pointer into a Shar tar shard: ``<tar_path>?o=<offset>&e=<end_offset>``)
    """

    channels: List[int]
    """A list of integer channel IDs available in this AudioSource."""

    source: Union[str, bytes]
    """The actual source to read from; interpretation depends on ``type``."""

    video: Optional[VideoInfo] = None
    """Optional information about the video contained in this source, if any."""

    @property
    def has_video(self) -> bool:
        return self.video is not None

    @property
    def format(self) -> str:
        return self._get_format()

    def load_audio(
        self, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        force_opus_sampling_rate: Optional[int] = None) -> np.ndarray:
        """
        Load the audio as float32 numpy array in [-1, 1]; shape
        ``(n_channels, n_samples)``; single-channel sources return
        ``(n_samples,)`` after the caller's channel selection.
        """
        source = self._prepare_for_reading(offset=offset, duration=duration)
        samples, sampling_rate = read_audio(
            source, offset=offset, duration=duration,
            force_opus_sampling_rate=force_opus_sampling_rate)
        # Explicit sanity check for duration (reference: source.py:98-110).
        if duration is not None:
            num_samples = samples.shape[0] if len(samples.shape) == 1 else samples.shape[1]
            available_duration = num_samples / sampling_rate
            if available_duration < duration - get_audio_duration_mismatch_tolerance():
                raise DurationMismatchError(
                    f"Requested more audio ({duration}s) than available ({available_duration}s)"
                )
        return samples.astype(np.float32)

    def with_path_prefix(self, path: Pathlike) -> "AudioSource":
        if self.type != "file":
            return self
        return fastcopy(self, source=str(Path(path) / self.source))

    def to_dict(self) -> dict:
        return asdict_nonull(self)

    @staticmethod
    def from_dict(data) -> "AudioSource":
        if "video" in data:
            raise not_ported("Video in audio sources")
        return AudioSource(**data)

    def __repr__(self):
        return (
            f"AudioSource(type='{self.type}', channels={self.channels}, "
            f"source='{self.source if isinstance(self.source, str) else '<binary-data>'}')"
        )

    def _prepare_for_reading(self, offset: Seconds, duration: Optional[Seconds]) -> PathOrFilelike:
        """
        Validate ``self.type`` and prepare the actual source for reading:
        either a path or a binary file-like object (reference: source.py:253).
        """
        assert self.type in (
            "file", "command", "url", "memory", "shar", "shar_ptr",
        ), f"Unexpected AudioSource type: '{self.type}'"

        source = self.source

        if self.type == "command":
            if (offset != 0.0 or duration is not None) and not AudioCache.enabled():
                warnings.warn(
                    "You requested a subset of a recording that is read via a bash command. "
                    "Expect large I/O overhead for many such reads; "
                    "lhotse_tpu_torch.caching.set_caching_enabled(True) mitigates the overhead."
                )
            audio_bytes = AudioCache.try_cache(self.source)
            if not audio_bytes:
                audio_bytes = _run_pipe(self.source)
                AudioCache.add_to_cache(self.source, audio_bytes)
            source = BytesIO(audio_bytes)

        elif self.type == "url":
            raise not_ported("Reading 'url' audio sources")

        elif self.type == "memory":
            assert isinstance(self.source, bytes), (
                "Corrupted manifest: AudioSource type is 'memory' but 'source' "
                f"is not bytes (found: '{type(self.source).__name__}')."
            )
            source = BytesIO(self.source)

        elif self.type == "shar":
            raise RuntimeError(
                "Inconsistent state: found an AudioSource with a Shar placeholder "
                "that was not filled during deserialization."
            )

        elif self.type == "shar_ptr":
            from lhotse_tpu_torch.shar.lazy_pointer import read_payload

            source = BytesIO(read_payload(self.source))

        return source

    def _get_format(self) -> str:
        """Infer the audio format from the file extension or binary data."""
        if self.type in ("file", "url"):
            return os.path.splitext(self.source)[-1][1:].lower()
        elif self.type in ("memory", "shar_ptr"):
            if self.type == "shar_ptr":
                from lhotse_tpu_torch.shar.lazy_pointer import read_payload

                payload = read_payload(self.source)
            else:
                payload = self.source
            magic = payload[:12]
            if magic[:4] in (b"RIFF", b"RF64"):
                return "wav"
            if magic[:4] == b"fLaC":
                return "flac"
            if magic[:4] == b"OggS":
                return "opus" if b"OpusHead" in payload[:1024] else "ogg"
            if magic[:7] == b"NIST_1A":
                return "sph"
            if magic[:3] == b"ID3" or (len(magic) > 1 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0):
                return "mp3"
            return "unknown"
        else:
            raise NotImplementedError(f"Getting format not implemented for source type {self.type}")


def _run_pipe(command: str) -> bytes:
    """The standard output of a shell pipe, timed as the ``audio.pipe`` span
    (inside the caller's ``audio.decode``). A non-zero exit raises with the
    pipe's stderr."""
    from lhotse_tpu_torch.tracing import trace_span

    with trace_span("audio.pipe"):
        proc = run(command, shell=True, stdout=PIPE, stderr=PIPE)
    if proc.returncode != 0:
        raise RuntimeError(
            f"The audio pipe '{command}' exited with code {proc.returncode}: "
            f"{proc.stderr.decode(errors='replace').strip()}"
        )
    return proc.stdout
