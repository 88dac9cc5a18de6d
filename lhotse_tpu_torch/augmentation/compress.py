"""
Lossy codec simulation (encode + decode round trip), copied from
``lhotse_tpu/augmentation/compress.py``.

Codecs opus/mp3/vorbis/gsm with a 0..1 ``compression_level``. Opus, MP3
and Vorbis round-trip in process through the system codec libraries
(:mod:`lhotse_tpu_torch.audio.syscodecs`), which give the JAX package's
arrays exactly. GSM, and a rate or library the system codecs do not
cover, go through an ``ffmpeg`` subprocess, as in the JAX package, and
raise a clear error where there is no ``ffmpeg``.

A channel subset of a compressed recording is compressed alone, as in the
JAX package: the encoders take one or two channels, and code two jointly,
so channel 0 of a compressed stereo recording read alone differs from
channel 0 read beside channel 1.
"""
from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass
from typing import ClassVar, Optional, Tuple

import numpy as np

from lhotse_tpu_torch.augmentation.transform import AudioTransform

try:
    from typing import Literal

    Codec = Literal["opus", "mp3", "vorbis", "gsm"]
except ImportError:  # pragma: no cover
    Codec = str

OPUS_SUPPORTED_SAMPLING_RATES = [8000, 12000, 16000, 24000, 48000]
MP3_SUPPORTED_SAMPLING_RATES = [8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000]

_FFMPEG_CODEC_ARGS = {
    "opus": ["-c:a", "libopus"], "mp3": ["-c:a", "libmp3lame"], "vorbis": ["-c:a", "libvorbis"],
    "gsm": ["-c:a", "libgsm"]}
_FFMPEG_FORMATS = {"opus": "ogg", "mp3": "mp3", "vorbis": "ogg", "gsm": "gsm"}


@dataclass
class Compress(AudioTransform):
    """Modifies audio by running it through a lossy codec."""

    supported_codecs: ClassVar[Tuple[str, ...]] = ("opus", "mp3", "vorbis", "gsm")
    codec: str = "opus"
    compression_level: Optional[float] = None

    def __post_init__(self):
        if self.codec not in self.supported_codecs:
            raise ValueError(f"Unsupported augmentation codec {self.codec}")
        if self.compression_level is not None and not 0 <= self.compression_level <= 1:
            raise ValueError("Compression level must be between 0 and 1")

    def __call__(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        if self.codec == "gsm":
            sampling_rate = 8000
        out = self._roundtrip_syscodec(samples, sampling_rate)
        if out is not None:
            return out
        if shutil.which("ffmpeg") is None:
            raise RuntimeError(
                "The Compress transform requires either the system codec "
                "libraries (libmp3lame/libmpg123, libvorbis, libopus) or the "
                "ffmpeg binary — none found. Install one or remove the "
                "compress transform."
            )
        from io import BytesIO

        from lhotse_tpu_torch.audio.wavio import read_wav, write_wav

        n_in = samples.shape[-1]
        buf = BytesIO()
        write_wav(buf, samples, sampling_rate, subtype="float32")
        # Map compression_level in [0,1] to a bitrate range per codec.
        quality_args = []
        if self.codec in ("opus", "mp3", "vorbis") and self.compression_level is not None:
            # higher level = more compression = lower bitrate
            kbps = int(round(256 - 224 * self.compression_level))  # 256..32 kbps
            quality_args = ["-b:a", f"{kbps}k"]
        enc = subprocess.run(
            ["ffmpeg", "-v", "error", "-f", "wav", "-i", "pipe:0"] + _FFMPEG_CODEC_ARGS[self.codec] + quality_args + ["-f", _FFMPEG_FORMATS[self.codec], "pipe:1"],
            input=buf.getvalue(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        if enc.returncode != 0:
            raise RuntimeError(f"ffmpeg encode failed: {enc.stderr.decode(errors='replace')}")
        dec = subprocess.run(
            [ "ffmpeg", "-v", "error", "-i", "pipe:0", "-ar", str(sampling_rate), "-f", "wav", "-c:a", "pcm_f32le", "pipe:1", ],
            input=enc.stdout, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        if dec.returncode != 0:
            raise RuntimeError(f"ffmpeg decode failed: {dec.stderr.decode(errors='replace')}")
        out, _ = read_wav(BytesIO(dec.stdout))
        # Codecs may add priming/padding samples; trim or pad to input length.
        if out.shape[-1] > n_in:
            out = out[:, :n_in]
        elif out.shape[-1] < n_in:
            out = np.pad(out, ((0, 0), (0, n_in - out.shape[-1])))
        return out.astype(samples.dtype, copy=False)

    def _roundtrip_syscodec(self, samples: np.ndarray, sampling_rate: int) -> Optional[np.ndarray]:
        """Encode+decode through the in-process system codec libraries
        (:mod:`lhotse_tpu_torch.audio.syscodecs`) — no subprocess, works without
        an ffmpeg binary. Returns None when the codec (or its libraries)
        are not covered, so the caller can fall back."""
        from lhotse_tpu_torch.audio import syscodecs as sc

        level = self.compression_level
        x = np.atleast_2d(np.asarray(samples, dtype=np.float32))
        n_in = x.shape[-1]
        try:
            if self.codec == "mp3":
                if not (sc.mp3_available() and sc.mp3_encode_available()):
                    return None
                if sampling_rate not in MP3_SUPPORTED_SAMPLING_RATES:
                    return None
                kbps = int(round(256 - 224 * level)) if level is not None else 192
                out, _ = sc.mp3_decode(sc.mp3_encode(x, sampling_rate, bitrate_kbps=kbps))
            elif self.codec == "vorbis":
                if not (sc.vorbis_available() and sc.vorbis_encode_available()):
                    return None
                # vorbis VBR quality spans -0.1 (smallest) .. 1.0 (best).
                q = 0.9 - 1.0 * level if level is not None else 0.4
                out, _ = sc.vorbis_decode(sc.vorbis_encode(x, sampling_rate, quality=q))
            elif self.codec == "opus":
                if not sc.opus_available():
                    return None
                bitrate = int(round((256 - 224 * level) * 1000)) if level is not None else 64000
                if sampling_rate in OPUS_SUPPORTED_SAMPLING_RATES:
                    enc_sr, enc_x = sampling_rate, x
                else:
                    from lhotse_tpu_torch.augmentation.resample import resample_array

                    enc_sr, enc_x = 48000, resample_array(x, sampling_rate, 48000)
                data = sc.opus_encode(enc_x, enc_sr, bitrate=bitrate)
                out, _ = sc.opus_decode(data, force_sampling_rate=sampling_rate)
            else:  # gsm — not covered by the system libraries
                return None
        except RuntimeError:
            return None
        if out.shape[-1] > n_in:
            out = out[:, :n_in]
        elif out.shape[-1] < n_in:
            out = np.pad(out, ((0, 0), (0, n_in - out.shape[-1])))
        return out.astype(np.asarray(samples).dtype, copy=False)

    def reverse_timestamps(self, offset, duration, sampling_rate):
        return offset, duration
