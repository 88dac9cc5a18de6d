"""
Audio decode/encode backends (copied from ``lhotse_tpu/audio/backend.py``):
the in-package NIST SPHERE (:mod:`lhotse_tpu_torch.audio.sphio`), WAV
(:mod:`lhotse_tpu_torch.audio.wavio`), FLAC
(:mod:`lhotse_tpu_torch.audio.flacio`) and AIFF
(:mod:`lhotse_tpu_torch.audio.aiffio`) codecs, then MP3, Ogg/Opus and
Ogg/Vorbis through the system codec libraries
(:mod:`lhotse_tpu_torch.audio.syscodecs`), behind the composite that
``read_audio``/``info``/``save_audio`` use, in the JAX package's order. A
lossy backend joins the composite only when its library loads. A member
without a suffix (a Shar payload, a ``memory`` source) is sniffed.
Shorten-compressed SPHERE goes to the ``sph2pipe`` binary where one is on
the ``PATH``, and raises ``SphereShortenError`` where none is.

Left out: the soundfile, audioread, torchcodec and ffmpeg backends. A file
none of the backends reads raises ``AudioLoadingError``; saving another
format raises ``NotImplementedError``. Saving as AIFF writes AIFF (the JAX
composite hands every format but WAV, FLAC and its lossy codecs to its
first saving backend, SPHERE).
"""
from __future__ import annotations

import shutil
import subprocess
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


class AiffBackend(AudioBackend):
    """AIFF / AIFF-C via the in-package numpy codec
    (:mod:`lhotse_tpu_torch.audio.aiffio`): BE/LE PCM 8/16/24/32, fl32/fl64,
    ulaw/alaw compression types; saves standard AIFF PCM16."""

    def read_audio(
        self, path_or_fd, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        force_opus_sampling_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
        from lhotse_tpu_torch.audio.aiffio import read_aiff

        samples, sr = read_aiff(path_or_fd)
        if offset or duration is not None:
            lo = compute_num_samples(offset, sr) if offset else 0
            hi = lo + compute_num_samples(duration, sr) if duration is not None else None
            samples = samples[:, lo:hi]
        return samples, sr

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        from lhotse_tpu_torch.audio.aiffio import info_aiff

        hdr = info_aiff(path_or_fd)
        return LibsndfileCompatibleAudioInfo(
            channels=hdr.num_channels, frames=hdr.num_frames, samplerate=hdr.sampling_rate,
            duration=hdr.num_frames / hdr.sampling_rate)

    def is_applicable(self, path_or_fd) -> bool:
        sfx = _suffix_of(path_or_fd)
        if sfx in (".aiff", ".aif", ".aifc"):
            return True
        try:
            if isinstance(path_or_fd, (str, Path)):
                with open(path_or_fd, "rb") as f:
                    magic = f.read(12)
            else:
                magic = _peek_bytes(path_or_fd, 12)
            return magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC")
        except Exception:
            return False

    def supports_info(self) -> bool:
        return True

    def supports_save(self) -> bool:
        return True

    def save_audio(self, dest, src, sampling_rate: int, format=None, encoding=None) -> None:
        from lhotse_tpu_torch.audio.aiffio import write_aiff

        write_aiff(dest, np.asarray(src), sampling_rate)


def _read_all(path_or_fd) -> Union[str, bytes]:
    """Pass paths through; drain file-like objects to bytes."""
    if isinstance(path_or_fd, (str, Path)):
        return path_or_fd
    pos = path_or_fd.tell() if hasattr(path_or_fd, "tell") else None
    data = path_or_fd.read()
    if pos is not None and hasattr(path_or_fd, "seek"):
        path_or_fd.seek(pos)
    return data


def _slice_seconds(audio: np.ndarray, sr: int, offset: Seconds, duration):
    if offset or duration is not None:
        lo = compute_num_samples(offset, sr) if offset else 0
        hi = lo + compute_num_samples(duration, sr) if duration is not None else None
        audio = audio[:, lo:hi]
    return audio


class Mpg123Backend(AudioBackend):
    """MP3 decode via the system libmpg123 (encode via libmp3lame), bound
    with ctypes (:mod:`lhotse_tpu_torch.audio.syscodecs`); in-memory
    sources decode without temp files."""

    @classmethod
    def is_available(cls) -> bool:
        from lhotse_tpu_torch.audio import syscodecs

        return syscodecs.mp3_available()

    def read_audio(
        self, path_or_fd, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        force_opus_sampling_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
        from lhotse_tpu_torch.audio import syscodecs

        audio, sr = syscodecs.mp3_decode(_read_all(path_or_fd))
        return _slice_seconds(audio, sr, offset, duration), sr

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        from lhotse_tpu_torch.audio import syscodecs

        sr, ch, n = syscodecs.mp3_info(_read_all(path_or_fd))
        return LibsndfileCompatibleAudioInfo(
            channels=ch, frames=n, samplerate=sr, duration=n / sr)

    def is_applicable(self, path_or_fd) -> bool:
        if not self.is_available():
            return False
        sfx = _suffix_of(path_or_fd)
        if sfx == ".mp3":
            return True
        if sfx is not None and sfx != "":
            return False
        from lhotse_tpu_torch.audio import syscodecs

        try:
            if isinstance(path_or_fd, (str, Path)):
                with open(path_or_fd, "rb") as f:
                    head = f.read(4)
            else:
                head = _peek_bytes(path_or_fd, 4)
            return syscodecs.looks_like_mp3(head)
        except Exception:
            return False

    def supports_info(self) -> bool:
        return True

    def supports_save(self) -> bool:
        from lhotse_tpu_torch.audio import syscodecs

        return syscodecs.mp3_encode_available()

    def save_audio(self, dest, src, sampling_rate: int, format=None, encoding=None) -> None:
        from lhotse_tpu_torch.audio import syscodecs

        data = syscodecs.mp3_encode(np.asarray(src), sampling_rate)
        if isinstance(dest, (str, Path)):
            Path(dest).write_bytes(data)
        else:
            dest.write(data)


def _sniff_ogg(path_or_fd) -> Optional[str]:
    from lhotse_tpu_torch.audio import syscodecs

    try:
        if isinstance(path_or_fd, (str, Path)):
            with open(path_or_fd, "rb") as f:
                head = f.read(320)
        else:
            head = _peek_bytes(path_or_fd, 320)
        return syscodecs.sniff_ogg_codec(head)
    except Exception:
        return None


class OggVorbisBackend(AudioBackend):
    """Ogg/Vorbis decode via the system libvorbisfile (encode via
    libvorbisenc+libogg); in-memory sources decode without temp files."""

    @classmethod
    def is_available(cls) -> bool:
        from lhotse_tpu_torch.audio import syscodecs

        return syscodecs.vorbis_available()

    def read_audio(
        self, path_or_fd, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        force_opus_sampling_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
        from lhotse_tpu_torch.audio import syscodecs

        src = _read_all(path_or_fd)
        sr, _, _ = syscodecs.vorbis_info(src)
        lo = compute_num_samples(offset, sr) if offset else 0
        n = compute_num_samples(duration, sr) if duration is not None else None
        audio, sr = syscodecs.vorbis_decode(src, offset_samples=lo, num_samples=n)
        return audio, sr

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        from lhotse_tpu_torch.audio import syscodecs

        sr, ch, n = syscodecs.vorbis_info(_read_all(path_or_fd))
        return LibsndfileCompatibleAudioInfo(
            channels=ch, frames=n, samplerate=sr, duration=n / sr)

    def is_applicable(self, path_or_fd) -> bool:
        if not self.is_available():
            return False
        sfx = _suffix_of(path_or_fd)
        if sfx in (".ogg", ".oga", None, ""):
            return _sniff_ogg(path_or_fd) == "vorbis"
        return False

    def supports_info(self) -> bool:
        return True

    def supports_save(self) -> bool:
        from lhotse_tpu_torch.audio import syscodecs

        return syscodecs.vorbis_encode_available()

    def save_audio(self, dest, src, sampling_rate: int, format=None, encoding=None) -> None:
        from lhotse_tpu_torch.audio import syscodecs

        data = syscodecs.vorbis_encode(np.asarray(src), sampling_rate)
        if isinstance(dest, (str, Path)):
            Path(dest).write_bytes(data)
        else:
            dest.write(data)


class OggOpusBackend(AudioBackend):
    """Ogg/Opus decode via the system libogg+libopus. Decodes at 48 kHz
    like the reference (OPUS always reports 48k) unless
    ``force_opus_sampling_rate`` is given — native decoder rates
    (8/12/16/24/48 kHz) decode directly, others decode at 48 kHz and
    polyphase-resample (reference: read_opus_ffmpeg,
    lhotse/audio/backend.py:1494)."""

    @classmethod
    def is_available(cls) -> bool:
        from lhotse_tpu_torch.audio import syscodecs

        return syscodecs.opus_available()

    def read_audio(
        self, path_or_fd, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        force_opus_sampling_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
        from lhotse_tpu_torch.audio import syscodecs

        audio, sr = syscodecs.opus_decode(
            _read_all(path_or_fd), force_sampling_rate=force_opus_sampling_rate)
        return _slice_seconds(audio, sr, offset, duration), sr

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        from lhotse_tpu_torch.audio import syscodecs

        sr, ch, n = syscodecs.opus_info(
            _read_all(path_or_fd), force_sampling_rate=force_opus_sampling_rate)
        return LibsndfileCompatibleAudioInfo(
            channels=ch, frames=n, samplerate=sr, duration=n / sr)

    def is_applicable(self, path_or_fd) -> bool:
        if not self.is_available():
            return False
        sfx = _suffix_of(path_or_fd)
        if sfx == ".opus":
            return True
        if sfx in (".ogg", ".oga", None, ""):
            return _sniff_ogg(path_or_fd) == "opus"
        return False

    def supports_info(self) -> bool:
        return True

    def supports_save(self) -> bool:
        return self.is_available()

    def save_audio(self, dest, src, sampling_rate: int, format=None, encoding=None) -> None:
        from lhotse_tpu_torch.audio import syscodecs

        data = syscodecs.opus_encode(np.asarray(src), sampling_rate)
        if isinstance(dest, (str, Path)):
            Path(dest).write_bytes(data)
        else:
            dest.write(data)


class SphereBackend(AudioBackend):
    """Native NIST SPHERE decode via :mod:`lhotse_tpu_torch.audio.sphio`
    (pure numpy: PCM/ulaw/alaw, partial reads); shorten-compressed files
    are delegated to :class:`Sph2pipeSubprocessBackend` when that binary
    exists."""

    def handles_special_case(self, path_or_fd) -> bool:
        sfx = _suffix_of(path_or_fd)
        if sfx is not None:
            # ".wav" is a candidate too: TIMIT and other LDC corpora ship
            # NIST SPHERE data behind a ".WAV" name. The magic check below is
            # authoritative, so genuine RIFF files fall through to the WAV
            # backend either way.
            if sfx not in (".sph", ".wv1", ".wv2", ".wav"):
                return False
            # Verify the magic: mislabeled files (e.g. RIFF behind a .sph
            # name) must fall through to the other backends.
            try:
                with open(path_or_fd, "rb") as f:
                    return f.read(7) == b"NIST_1A"
            except Exception:
                return False
        try:
            return _peek_bytes(path_or_fd, 7) == b"NIST_1A"
        except Exception:
            return False

    is_applicable = handles_special_case

    def read_audio(
        self, path_or_fd, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
        force_opus_sampling_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
        from lhotse_tpu_torch.audio.sphio import SphereShortenError, info_sph, read_sph

        try:
            hdr = info_sph(path_or_fd)
            frame_offset = compute_num_samples(offset, hdr.sampling_rate) if offset else 0
            num_frames = (
                compute_num_samples(duration, hdr.sampling_rate)
                if duration is not None else None)
            return read_sph(path_or_fd, frame_offset=frame_offset, num_frames=num_frames)
        except SphereShortenError:
            if Sph2pipeSubprocessBackend.is_available():
                return Sph2pipeSubprocessBackend().read_audio(
                    path_or_fd, offset=offset, duration=duration)
            raise

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        from lhotse_tpu_torch.audio.sphio import info_sph

        hdr = info_sph(path_or_fd)
        return LibsndfileCompatibleAudioInfo(
            channels=hdr.num_channels, frames=hdr.sample_count,
            samplerate=hdr.sampling_rate, duration=hdr.duration)

    def supports_info(self) -> bool:
        return True

    def supports_save(self) -> bool:
        return True

    def save_audio(self, dest, src, sampling_rate: int, format=None, encoding=None) -> None:
        from lhotse_tpu_torch.audio.sphio import write_sph

        coding = {None: "pcm16", "PCM_16": "pcm16", "ULAW": "ulaw", "ALAW": "alaw"}.get(
            encoding, encoding or "pcm16")
        write_sph(dest, np.asarray(src), sampling_rate, coding=coding)


class Sph2pipeSubprocessBackend(AudioBackend):
    """SPHERE (incl. shorten-compressed) decode via the ``sph2pipe`` binary."""

    @classmethod
    def is_available(cls) -> bool:
        return shutil.which("sph2pipe") is not None

    def handles_special_case(self, path_or_fd) -> bool:
        sfx = _suffix_of(path_or_fd)
        if sfx is not None:
            return sfx in (".sph", ".wv1", ".wv2")
        try:
            return _peek_bytes(path_or_fd, 7) == b"NIST_1A"
        except Exception:
            return False

    is_applicable = handles_special_case

    def read_audio(
        self, path_or_fd, offset=0.0, duration=None, force_opus_sampling_rate=None,
    ) -> Tuple[np.ndarray, int]:
        assert isinstance(path_or_fd, (str, Path)), "sph2pipe backend supports only file paths"
        cmd = ["sph2pipe", "-f", "wav", "-p", str(path_or_fd)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        if proc.returncode != 0:
            raise AudioLoadingError(f"sph2pipe failed: {proc.stderr.decode(errors='replace')}")
        return InternalWavBackend().read_audio(
            BytesIO(proc.stdout), offset=offset, duration=duration)

    def info(self, path_or_fd, force_opus_sampling_rate=None) -> LibsndfileCompatibleAudioInfo:
        samples, sr = self.read_audio(path_or_fd)
        return LibsndfileCompatibleAudioInfo(
            channels=samples.shape[0], frames=samples.shape[1], samplerate=sr,
            duration=samples.shape[1] / sr)

    def supports_info(self) -> bool:
        return True


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
        if fmt in ("sph", "wv1", "wv2"):
            return SphereBackend().save_audio(
                dest, src, sampling_rate, format=fmt, encoding=encoding)
        if fmt in ("aiff", "aif", "aifc"):
            return AiffBackend().save_audio(dest, src, sampling_rate)
        if fmt == "mp3" and Mpg123Backend().supports_save():
            return Mpg123Backend().save_audio(dest, src, sampling_rate)
        if fmt in ("ogg", "vorbis", "oga") and OggVorbisBackend().supports_save():
            return OggVorbisBackend().save_audio(dest, src, sampling_rate)
        if fmt == "opus" and OggOpusBackend().supports_save():
            return OggOpusBackend().save_audio(dest, src, sampling_rate)
        raise not_ported(
            f"Saving audio as {fmt!r} (the package writes wav, flac, sph and aiff, and mp3, "
            "ogg and opus where the system codec libraries load)")


def available_audio_backends() -> List[str]:
    """List the names of all available audio backends."""
    return sorted(name for name, b in AudioBackend.KNOWN_BACKENDS.items() if b.is_available())


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
    """Composite over the package's codecs, in the JAX package's order."""
    # SphereBackend subsumes the sph2pipe subprocess backend: it decodes
    # pcm/ulaw/alaw natively and delegates shorten files to sph2pipe itself.
    backends: List[AudioBackend] = [
        SphereBackend(), InternalWavBackend(), FlacBackend(), AiffBackend()]
    # Lossy codecs through the system libraries (ctypes): each registers only
    # when its library loads.
    if Mpg123Backend.is_available():
        backends.append(Mpg123Backend())
    if OggOpusBackend.is_available():
        backends.append(OggOpusBackend())
    if OggVorbisBackend.is_available():
        backends.append(OggVorbisBackend())
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


def read_sph(
    sph_path: Pathlike, offset: Seconds = 0.0, duration: Optional[Seconds] = None,
) -> Tuple[np.ndarray, int]:
    """
    Read a SPHERE file with seconds-based offset/duration (reference
    contract: audio/backend.py:1603, a sph2pipe subprocess there; decoded
    natively here).

    :return: ``(samples(channels, frames) float32, sampling_rate)``.
    """
    from lhotse_tpu_torch.audio.sphio import info_sph
    from lhotse_tpu_torch.audio.sphio import read_sph as read_sph_frames

    frame_offset = 0
    num_frames = None
    if offset > 0 or duration is not None:
        rate = info_sph(sph_path).sampling_rate
        if offset > 0:
            frame_offset = compute_num_samples(offset, rate)
        if duration is not None:
            num_frames = compute_num_samples(duration, rate)
    return read_sph_frames(sph_path, frame_offset=frame_offset, num_frames=num_frames)


def save_audio(
    dest: Union[str, Path, BytesIO], src: np.ndarray, sampling_rate: int,
    format: Optional[str] = None, encoding: Optional[str] = None) -> None:
    """Save audio samples (reference: audio/backend.py:1646)."""
    return get_current_audio_backend().save_audio(
        dest, src, sampling_rate, format=format, encoding=encoding)
