"""
Audio decode/encode backends (copied from ``lhotse_tpu/audio/backend.py``):
the in-package WAV codec (:mod:`lhotse_tpu_torch.audio.wavio`) and FLAC
codec (:mod:`lhotse_tpu_torch.audio.flacio`) behind the composite that
``read_audio``/``info``/``save_audio`` use.

Left out: the SPHERE, AIFF, MP3, Ogg/Vorbis, Opus, soundfile, audioread,
torchcodec and ffmpeg backends. A file none of the two backends reads
raises ``AudioLoadingError``; saving another format raises
``NotImplementedError``.
"""
from __future__ import annotations

from io import BytesIO
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Type, Union

import numpy as np

from lhotse_tpu_torch.audio.utils import AudioLoadingError, VideoInfo
from lhotse_tpu_torch.audio.wavio import info_wav, read_wav, write_wav
from lhotse_tpu_torch.utils import Pathlike, Seconds, compute_num_samples, not_ported

FileObject = Any

CURRENT_AUDIO_BACKEND: Optional["AudioBackend"] = None


class LibsndfileCompatibleAudioInfo(NamedTuple):
    channels: int
    frames: int
    samplerate: int
    duration: float
    video: Optional[VideoInfo] = None


class AudioBackend:
    """
    An AudioBackend defines methods for reading audio and two filters that
    determine whether it should be used (reference: audio/backend.py:196).

    ``handles_special_case`` = backend should be used exclusively for the input.
    ``is_applicable`` = backend can likely handle the input (may still fail).
    """

    KNOWN_BACKENDS: Dict[str, Type["AudioBackend"]] = {}

    def __init_subclass__(cls, **kwargs):
        if cls.__name__ not in AudioBackend.KNOWN_BACKENDS:
            AudioBackend.KNOWN_BACKENDS[cls.__name__] = cls
        super().__init_subclass__(**kwargs)

    @classmethod
    def new(cls, name: str) -> "AudioBackend":
        if name not in cls.KNOWN_BACKENDS:
            raise RuntimeError(f"Unknown audio backend name: {name}")
        return cls.KNOWN_BACKENDS[name]()

    @classmethod
    def is_available(cls) -> bool:
        return True

    def read_audio(
        self, path_or_fd: Union[Pathlike, FileObject], offset: Seconds = 0.0,
        duration: Optional[Seconds] = None, force_opus_sampling_rate: Optional[int] = None,
    ) -> Tuple[np.ndarray, int]:
        raise NotImplementedError()

    def info(
        self, path_or_fd: Union[Pathlike, FileObject],
        force_opus_sampling_rate: Optional[int] = None) -> LibsndfileCompatibleAudioInfo:
        raise NotImplementedError()

    def handles_special_case(self, path_or_fd: Union[Pathlike, FileObject]) -> bool:
        return False

    def is_applicable(self, path_or_fd: Union[Pathlike, FileObject]) -> bool:
        return True

    def supports_save(self) -> bool:
        return False

    def supports_info(self) -> bool:
        return False

    def save_audio(
        self, dest: Union[str, Path, BytesIO], src: np.ndarray, sampling_rate: int,
        format: Optional[str] = None, encoding: Optional[str] = None) -> None:
        raise NotImplementedError()


def _suffix_of(path_or_fd) -> Optional[str]:
    if isinstance(path_or_fd, (str, Path)):
        return Path(path_or_fd).suffix.lower()
    return None


def _peek_bytes(fd, n: int = 8) -> bytes:
    pos = fd.tell()
    data = fd.read(n)
    fd.seek(pos)
    return data


class InternalWavBackend(AudioBackend):
    """Default backend for RIFF/WAVE using the in-repo numpy codec
    (:mod:`lhotse_tpu_torch.audio.wavio`)."""

    def read_audio(
        self, path_or_fd, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        force_opus_sampling_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
        # Probe header first to translate seconds -> frames.
        if isinstance(path_or_fd, (str, Path)):
            hdr = info_wav(path_or_fd)
            f = open(path_or_fd, "rb")
            close = True
        else:
            hdr = info_wav(path_or_fd)
            f = path_or_fd
            close = False
        try:
            frame_offset = compute_num_samples(offset, hdr.sampling_rate) if offset else 0
            num_frames = (
                compute_num_samples(duration, hdr.sampling_rate)
                if duration is not None
                else None
            )
            samples, sr = read_wav(f, frame_offset=frame_offset, num_frames=num_frames)
            return samples, sr
        finally:
            if close:
                f.close()

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        hdr = info_wav(path_or_fd)
        return LibsndfileCompatibleAudioInfo(
            channels=hdr.num_channels, frames=hdr.num_frames, samplerate=hdr.sampling_rate,
            duration=hdr.num_frames / hdr.sampling_rate)

    def is_applicable(self, path_or_fd) -> bool:
        sfx = _suffix_of(path_or_fd)
        if sfx in (".wav", ".wave", ".rf64", ".bw64"):
            return True
        # Unrecognized suffix: sniff the magic bytes (handles mislabeled
        # files, e.g. RIFF data behind a .sph name).
        try:
            if isinstance(path_or_fd, (str, Path)):
                with open(path_or_fd, "rb") as f:
                    magic = f.read(4)
            else:
                magic = _peek_bytes(path_or_fd, 4)
            return magic in (b"RIFF", b"RF64")
        except Exception:
            return False

    def supports_info(self) -> bool:
        return True

    def supports_save(self) -> bool:
        return True

    def save_audio(self, dest, src, sampling_rate: int, format=None, encoding=None) -> None:
        subtype = {
            None: "pcm16", "PCM_16": "pcm16", "PCM_24": "pcm24", "PCM_32": "pcm32",
            "FLOAT": "float32", "DOUBLE": "float64"}.get(encoding, encoding or "pcm16")
        write_wav(dest, np.asarray(src), sampling_rate, subtype=subtype)


class FlacBackend(AudioBackend):
    """FLAC decode/encode via the in-repo pure-Python/numpy codec
    (:mod:`lhotse_tpu_torch.audio.flacio`)."""

    def read_audio(
        self, path_or_fd, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        force_opus_sampling_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
        from lhotse_tpu_torch.audio.flacio import read_flac

        samples, sr = read_flac(path_or_fd)
        if offset or duration is not None:
            lo = compute_num_samples(offset, sr) if offset else 0
            hi = lo + compute_num_samples(duration, sr) if duration is not None else None
            samples = samples[:, lo:hi]
        return samples, sr

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        from lhotse_tpu_torch.audio.flacio import info_flac

        hdr = info_flac(path_or_fd)
        return LibsndfileCompatibleAudioInfo(
            channels=hdr.num_channels, frames=hdr.num_frames, samplerate=hdr.sampling_rate,
            duration=hdr.num_frames / hdr.sampling_rate)

    def is_applicable(self, path_or_fd) -> bool:
        sfx = _suffix_of(path_or_fd)
        if sfx == ".flac":
            return True
        try:
            if isinstance(path_or_fd, (str, Path)):
                with open(path_or_fd, "rb") as f:
                    magic = f.read(4)
            else:
                magic = _peek_bytes(path_or_fd, 4)
            return magic == b"fLaC"
        except Exception:
            return False

    def supports_info(self) -> bool:
        return True

    def supports_save(self) -> bool:
        return True

    def save_audio(self, dest, src, sampling_rate: int, format=None, encoding=None) -> None:
        from lhotse_tpu_torch.audio.flacio import write_flac

        write_flac(dest, np.asarray(src), sampling_rate)


class CompositeAudioBackend(AudioBackend):
    """
    Composite trying each child backend: first those claiming a special case,
    then all applicable ones, collecting exceptions (reference:
    audio/backend.py:683).
    """

    def __init__(self, backends: List[AudioBackend]):
        self.backends = backends

    def _run(self, method: str, path_or_fd, **kwargs):
        candidates = [b for b in self.backends if b.handles_special_case(path_or_fd)]
        assert len(candidates) < 2, (
            f"CompositeAudioBackend has more than one sub-backend claiming "
            f"a special case for input: {path_or_fd}"
        )
        if candidates:
            return getattr(candidates[0], method)(path_or_fd, **kwargs)
        exceptions = []
        for b in self.backends:
            if not b.is_applicable(path_or_fd):
                continue
            if method == "info" and not b.supports_info():
                continue
            try:
                return getattr(b, method)(path_or_fd, **kwargs)
            except Exception as e:
                exceptions.append(f"{type(b).__name__}: {type(e).__name__}: {e}")
        npath = path_or_fd if isinstance(path_or_fd, (str, Path)) else "<file-like-object>"
        detail = "\n".join(exceptions) if exceptions else "(no applicable backend found)"
        raise AudioLoadingError(f"Reading audio from '{npath}' failed. Details:\n{detail}")

    def read_audio(
        self, path_or_fd, offset=0.0, duration=None, force_opus_sampling_rate=None,
    ) -> Tuple[np.ndarray, int]:
        return self._run(
            "read_audio", path_or_fd, offset=offset, duration=duration,
            force_opus_sampling_rate=force_opus_sampling_rate)

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        return self._run("info", path_or_fd, force_opus_sampling_rate=force_opus_sampling_rate)

    def supports_info(self) -> bool:
        return True

    def supports_save(self) -> bool:
        return any(b.supports_save() for b in self.backends)

    def save_audio(self, dest, src, sampling_rate: int, format=None, encoding=None) -> None:
        fmt = format
        if fmt is None and isinstance(dest, (str, Path)):
            fmt = Path(dest).suffix.lstrip(".").lower() or None
        if fmt in (None, "wav", "wave"):
            return InternalWavBackend().save_audio(
                dest, src, sampling_rate, format=fmt, encoding=encoding)
        if fmt == "flac":
            return FlacBackend().save_audio(dest, src, sampling_rate)
        raise not_ported(f"Saving audio as {fmt!r} (the package writes wav and flac)")


def set_current_audio_backend(backend: Union[str, AudioBackend]) -> AudioBackend:
    """Force a specific audio backend for all read/info/save operations."""
    global CURRENT_AUDIO_BACKEND
    if backend == "default":
        backend = get_default_audio_backend()
    elif isinstance(backend, str):
        backend = AudioBackend.new(backend)
    else:
        assert isinstance(backend, AudioBackend)
    CURRENT_AUDIO_BACKEND = backend
    return CURRENT_AUDIO_BACKEND


def get_current_audio_backend() -> AudioBackend:
    global CURRENT_AUDIO_BACKEND
    if CURRENT_AUDIO_BACKEND is not None:
        return CURRENT_AUDIO_BACKEND
    return get_default_audio_backend()


def get_default_audio_backend() -> AudioBackend:
    """Composite over the package's two codecs."""
    backends: List[AudioBackend] = [InternalWavBackend(), FlacBackend()]
    return CompositeAudioBackend(backends)


class audio_backend:
    """Context manager that temporarily overrides the audio backend."""

    def __init__(self, backend: Union[str, AudioBackend]):
        self.backend = backend
        self.prev = None

    def __enter__(self):
        global CURRENT_AUDIO_BACKEND
        self.prev = CURRENT_AUDIO_BACKEND
        set_current_audio_backend(self.backend)
        return self

    def __exit__(self, *exc):
        global CURRENT_AUDIO_BACKEND
        CURRENT_AUDIO_BACKEND = self.prev


def read_audio(
    path_or_fd: Union[Pathlike, FileObject], offset: Seconds = 0.0,
    duration: Optional[Seconds] = None, force_opus_sampling_rate: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Read audio returning ``(samples(channels, frames) float32, sampling_rate)``
    (reference: audio/backend.py:1662)."""
    return get_current_audio_backend().read_audio(
        path_or_fd, offset=offset, duration=duration,
        force_opus_sampling_rate=force_opus_sampling_rate)


def info(
    path: Union[Pathlike, FileObject], force_opus_sampling_rate: Optional[int] = None,
    force_read_audio: bool = False) -> LibsndfileCompatibleAudioInfo:
    """Probe audio metadata, preferring header-only reads (reference: audio/backend.py:1676)."""
    backend = get_current_audio_backend()
    if force_read_audio:
        samples, sr = backend.read_audio(
            path, force_opus_sampling_rate=force_opus_sampling_rate)
        return LibsndfileCompatibleAudioInfo(
            channels=samples.shape[0], frames=samples.shape[1], samplerate=sr,
            duration=samples.shape[1] / sr)
    return backend.info(path, force_opus_sampling_rate=force_opus_sampling_rate)


def save_audio(
    dest: Union[str, Path, BytesIO], src: np.ndarray, sampling_rate: int,
    format: Optional[str] = None, encoding: Optional[str] = None) -> None:
    """Save audio samples (reference: audio/backend.py:1646)."""
    return get_current_audio_backend().save_audio(
        dest, src, sampling_rate, format=format, encoding=encoding)
