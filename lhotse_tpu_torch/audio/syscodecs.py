"""
Lossy-codec decode/encode through stable system C libraries (ctypes),
copied from ``lhotse_tpu/audio/syscodecs.py``:

- MP3:        libmpg123 (decode), libmp3lame (encode)
- Ogg/Vorbis: libvorbisfile (decode), libvorbis+libvorbisenc+libogg (encode)
- Ogg/Opus:   libogg+libopus (decode and encode, RFC 7845 encapsulation)

Both packages call the same C libraries with the same arguments, so the
port's encodes are byte-equal to the JAX package's and its decodes
``array_equal``. Opus decodes at its native rates; another
``force_sampling_rate`` is reached through the port's
:func:`~lhotse_tpu_torch.augmentation.resample.resample_array`.

Every entry point degrades gracefully: `*_available()` report False when a
library is absent and the audio-backend registry simply skips the backend.
All decoders return float32 in [-1, 1], shaped (num_channels, num_samples).
Each call creates and frees its own decoder or encoder handle, so the
module serves the loader's thread workers and forked worker processes.
"""
from __future__ import annotations

import ctypes
import threading
from ctypes import (
    CFUNCTYPE,
    POINTER,
    byref,
    c_char_p,
    c_double,
    c_float,
    c_int,
    c_int64,
    c_long,
    c_size_t,
    c_ubyte,
    c_void_p,
    cast,
    create_string_buffer,
)
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

Pathlike = Union[str, Path]

_LOCK = threading.Lock()
_LIBS: dict = {}


def _load(name: str) -> Optional[ctypes.CDLL]:
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            lib = None
        _LIBS[name] = lib
        return lib


def loaded_sonames() -> Dict[str, bool]:
    """Each shared library asked for so far, and whether it loaded."""
    with _LOCK:
        return {name: lib is not None for name, lib in _LIBS.items()}


def _as_bytes(source: Union[Pathlike, bytes]) -> bytes:
    if isinstance(source, (str, Path)):
        return Path(source).read_bytes()
    return bytes(source)


# ===========================================================================
# MP3 — libmpg123 (decode) / libmp3lame (encode)
# ===========================================================================

# mpg123.h constants (stable ABI)
_MPG123_FLAGS = 1
_MPG123_FORCE_FLOAT = 0x400
_MPG123_GAPLESS = 0x40
_MPG123_QUIET = 0x20
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10

_mpg123 = None
_mpg123_failed = False


def _get_mpg123():
    global _mpg123, _mpg123_failed
    if _mpg123 is not None or _mpg123_failed:
        return _mpg123
    lib = _load("libmpg123.so.0")
    if lib is None:
        _mpg123_failed = True
        return None
    try:
        lib.mpg123_init()
        lib.mpg123_new.restype = c_void_p
        lib.mpg123_new.argtypes = [c_char_p, POINTER(c_int)]
        lib.mpg123_param.argtypes = [c_void_p, c_int, c_long, c_double]
        lib.mpg123_open.argtypes = [c_void_p, c_char_p]
        lib.mpg123_open_feed.argtypes = [c_void_p]
        lib.mpg123_feed.argtypes = [c_void_p, POINTER(c_ubyte), c_size_t]
        lib.mpg123_read.argtypes = [c_void_p, c_void_p, c_size_t, POINTER(c_size_t)]
        lib.mpg123_getformat.argtypes = [
            c_void_p, POINTER(c_long), POINTER(c_int), POINTER(c_int)]
        lib.mpg123_format_none.argtypes = [c_void_p]
        lib.mpg123_format.argtypes = [c_void_p, c_long, c_int, c_int]
        lib.mpg123_scan.argtypes = [c_void_p]
        lib.mpg123_length.restype = c_int64
        lib.mpg123_length.argtypes = [c_void_p]
        lib.mpg123_seek.restype = c_int64
        lib.mpg123_seek.argtypes = [c_void_p, c_int64, c_int]
        lib.mpg123_close.argtypes = [c_void_p]
        lib.mpg123_delete.argtypes = [c_void_p]
    except AttributeError:
        _mpg123_failed = True
        return None
    _mpg123 = lib
    return lib


def mp3_available() -> bool:
    return _get_mpg123() is not None


def mp3_encode_available() -> bool:
    return _get_lame() is not None


class _Mpg123Handle:
    def __init__(self, lib):
        self.lib = lib
        err = c_int(0)
        self.h = lib.mpg123_new(None, byref(err))
        if not self.h:
            raise RuntimeError(f"mpg123_new failed (err={err.value})")
        # float32 output, gapless trimming (LAME delay/padding), quiet.
        lib.mpg123_param(
            self.h, _MPG123_FLAGS,
            _MPG123_FORCE_FLOAT | _MPG123_GAPLESS | _MPG123_QUIET, 0.0)

    def close(self):
        if self.h:
            self.lib.mpg123_close(self.h)
            self.lib.mpg123_delete(self.h)
            self.h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _mpg123_drain(lib, h, first_rc=None) -> Tuple[np.ndarray, int, int]:
    """Read the full decoded stream; returns (flat f32, rate, channels)."""
    rate = c_long(0)
    channels = c_int(0)
    enc = c_int(0)
    chunks: List[np.ndarray] = []
    bufsize = 1 << 18
    buf = create_string_buffer(bufsize)
    done = c_size_t(0)
    got_fmt = False
    while True:
        rc = lib.mpg123_read(h, buf, bufsize, byref(done)) if first_rc is None else first_rc
        first_rc = None
        if rc == _MPG123_NEW_FORMAT:
            lib.mpg123_getformat(h, byref(rate), byref(channels), byref(enc))
            # Pin the format so mpg123 cannot renegotiate mid-stream.
            lib.mpg123_format_none(h)
            lib.mpg123_format(h, rate.value, channels.value, _MPG123_ENC_FLOAT_32)
            got_fmt = True
            continue
        if done.value:
            chunks.append(
                np.frombuffer(buf.raw[: done.value], dtype=np.float32).copy())
            done.value = 0
        if rc in (_MPG123_DONE, _MPG123_NEED_MORE):
            break
        if rc not in (_MPG123_OK,):
            if rc < 0:
                raise RuntimeError(f"mpg123_read error rc={rc}")
    if not got_fmt:
        lib.mpg123_getformat(h, byref(rate), byref(channels), byref(enc))
    flat = (
        np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.float32)
    )
    return flat, int(rate.value), max(1, int(channels.value))


def mp3_info(source: Union[Pathlike, bytes]) -> Tuple[int, int, int]:
    """(sampling_rate, num_channels, num_samples) of an MP3 stream."""
    lib = _get_mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    if isinstance(source, (str, Path)):
        with _Mpg123Handle(lib) as mh:
            if lib.mpg123_open(mh.h, str(source).encode()) != _MPG123_OK:
                raise RuntimeError(f"mpg123_open failed: {source}")
            rate = c_long(0)
            channels = c_int(0)
            enc = c_int(0)
            lib.mpg123_getformat(mh.h, byref(rate), byref(channels), byref(enc))
            lib.mpg123_scan(mh.h)
            n = lib.mpg123_length(mh.h)
            return int(rate.value), max(1, int(channels.value)), max(0, int(n))
    # In-memory: decode fully (no cheap exact scan through the feed API).
    audio, sr = mp3_decode(source)
    return sr, audio.shape[0], audio.shape[1]


def mp3_decode(
    source: Union[Pathlike, bytes],
    offset_samples: int = 0,
    num_samples: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """
    Decode MP3 to float32 (channels, samples). Path inputs use mpg123's
    native IO with sample-accurate seeking (post-scan); byte inputs decode
    through the feed API and slice.
    """
    lib = _get_mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    with _Mpg123Handle(lib) as mh:
        if isinstance(source, (str, Path)):
            if lib.mpg123_open(mh.h, str(source).encode()) != _MPG123_OK:
                raise RuntimeError(f"mpg123_open failed: {source}")
            if offset_samples:
                lib.mpg123_scan(mh.h)
                lib.mpg123_seek(mh.h, offset_samples, 0)  # SEEK_SET
            flat, rate, ch = _mpg123_drain(lib, mh.h)
            audio = flat.reshape(-1, ch).T
            if num_samples is not None:
                audio = audio[:, :num_samples]
            return np.ascontiguousarray(audio), rate
        data = _as_bytes(source)
        lib.mpg123_open_feed(mh.h)
        arr = (c_ubyte * len(data)).from_buffer_copy(data)
        lib.mpg123_feed(mh.h, arr, len(data))
        flat, rate, ch = _mpg123_drain(lib, mh.h)
        audio = flat.reshape(-1, ch).T
        if offset_samples:
            audio = audio[:, offset_samples:]
        if num_samples is not None:
            audio = audio[:, :num_samples]
        return np.ascontiguousarray(audio), rate


_lame = None
_lame_failed = False


def _get_lame():
    global _lame, _lame_failed
    if _lame is not None or _lame_failed:
        return _lame
    lib = _load("libmp3lame.so.0")
    if lib is None:
        _lame_failed = True
        return None
    try:
        lib.lame_init.restype = c_void_p
        lib.lame_set_in_samplerate.argtypes = [c_void_p, c_int]
        lib.lame_set_num_channels.argtypes = [c_void_p, c_int]
        lib.lame_set_brate.argtypes = [c_void_p, c_int]
        lib.lame_set_bWriteVbrTag.argtypes = [c_void_p, c_int]
        lib.lame_init_params.argtypes = [c_void_p]
        lib.lame_encode_buffer_ieee_float.restype = c_int
        lib.lame_encode_buffer_ieee_float.argtypes = [
            c_void_p, POINTER(c_float), POINTER(c_float), c_int,
            POINTER(c_ubyte), c_int]
        lib.lame_encode_flush.restype = c_int
        lib.lame_encode_flush.argtypes = [c_void_p, POINTER(c_ubyte), c_int]
        lib.lame_get_lametag_frame.restype = c_size_t
        lib.lame_get_lametag_frame.argtypes = [c_void_p, POINTER(c_ubyte), c_size_t]
        lib.lame_close.argtypes = [c_void_p]
    except AttributeError:
        _lame_failed = True
        return None
    _lame = lib
    return lib


def mp3_encode(
    samples: np.ndarray, sampling_rate: int, bitrate_kbps: int = 192
) -> bytes:
    """Encode float32 (channels, samples) or (samples,) to MP3 bytes with a
    LAME/Xing tag (so mpg123's gapless trimming recovers exact length)."""
    lib = _get_lame()
    if lib is None:
        raise RuntimeError("libmp3lame not available")
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    ch, n = x.shape
    if ch > 2:
        raise ValueError("MP3 supports at most 2 channels")
    gf = lib.lame_init()
    if not gf:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gf, int(sampling_rate))
        lib.lame_set_num_channels(gf, ch)
        lib.lame_set_brate(gf, int(bitrate_kbps))
        lib.lame_set_bWriteVbrTag(gf, 1)
        if lib.lame_init_params(gf) < 0:
            raise RuntimeError(
                f"lame_init_params failed (sampling rate {sampling_rate} "
                f"unsupported by MP3?)")
        left = np.ascontiguousarray(x[0])
        right = np.ascontiguousarray(x[1] if ch == 2 else x[0])
        outsz = int(1.25 * n + 7200) + 7200
        out = (c_ubyte * outsz)()
        nb = lib.lame_encode_buffer_ieee_float(
            gf,
            left.ctypes.data_as(POINTER(c_float)),
            right.ctypes.data_as(POINTER(c_float)),
            n, out, outsz)
        if nb < 0:
            raise RuntimeError(f"lame_encode_buffer failed rc={nb}")
        parts = [bytes(out[:nb])]
        nb = lib.lame_encode_flush(gf, out, outsz)
        if nb > 0:
            parts.append(bytes(out[:nb]))
        body = b"".join(parts)
        # Patch the placeholder Xing/LAME tag frame (stream head) with the
        # real delay/padding/length values so decoders trim gaplessly —
        # mpg123 then reproduces the exact sample count.
        n_tag = lib.lame_get_lametag_frame(gf, out, outsz)
        if 0 < n_tag <= len(body):
            body = bytes(out[:n_tag]) + body[n_tag:]
        return body
    finally:
        lib.lame_close(gf)


# ===========================================================================
# Ogg/Vorbis — libvorbisfile (decode), libvorbis(+enc)+libogg (encode)
# ===========================================================================


class _OvCallbacks(ctypes.Structure):
    _fields_ = [
        ("read", CFUNCTYPE(c_size_t, c_void_p, c_size_t, c_size_t, c_void_p)),
        ("seek", CFUNCTYPE(c_int, c_void_p, c_int64, c_int)),
        ("close", CFUNCTYPE(c_int, c_void_p)),
        ("tell", CFUNCTYPE(c_long, c_void_p)),
    ]


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", c_int),
        ("channels", c_int),
        ("rate", c_long),
        ("bitrate_upper", c_long),
        ("bitrate_nominal", c_long),
        ("bitrate_lower", c_long),
        ("bitrate_window", c_long),
        ("codec_setup", c_void_p),
    ]


_vorbisfile = None
_vorbisfile_failed = False


def _get_vorbisfile():
    global _vorbisfile, _vorbisfile_failed
    if _vorbisfile is not None or _vorbisfile_failed:
        return _vorbisfile
    lib = _load("libvorbisfile.so.3")
    if lib is None:
        _vorbisfile_failed = True
        return None
    try:
        lib.ov_open_callbacks.restype = c_int
        lib.ov_open_callbacks.argtypes = [
            c_void_p, c_void_p, c_char_p, c_long, _OvCallbacks]
        lib.ov_info.restype = POINTER(_VorbisInfo)
        lib.ov_info.argtypes = [c_void_p, c_int]
        lib.ov_pcm_total.restype = c_int64
        lib.ov_pcm_total.argtypes = [c_void_p, c_int]
        lib.ov_pcm_seek.restype = c_int
        lib.ov_pcm_seek.argtypes = [c_void_p, c_int64]
        lib.ov_read_float.restype = c_long
        lib.ov_read_float.argtypes = [
            c_void_p, POINTER(POINTER(POINTER(c_float))), c_int, POINTER(c_int)]
        lib.ov_clear.argtypes = [c_void_p]
    except AttributeError:
        _vorbisfile_failed = True
        return None
    _vorbisfile = lib
    return lib


def vorbis_available() -> bool:
    return _get_vorbisfile() is not None


class _MemReader:
    """read/seek/tell callbacks over a bytes buffer for ov_open_callbacks."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        # Keep the CFUNCTYPE objects alive for the lifetime of the reader.
        self.cb = _OvCallbacks(
            read=_OvCallbacks._fields_[0][1](self._read),
            seek=_OvCallbacks._fields_[1][1](self._seek),
            close=_OvCallbacks._fields_[2][1](lambda h: 0),
            tell=_OvCallbacks._fields_[3][1](self._tell),
        )

    def _read(self, ptr, size, nmemb, _h) -> int:
        want = size * nmemb
        chunk = self.data[self.pos : self.pos + want]
        if chunk:
            ctypes.memmove(ptr, chunk, len(chunk))
            self.pos += len(chunk)
        return len(chunk) // size if size else 0

    def _seek(self, _h, offset, whence) -> int:
        if whence == 0:
            self.pos = offset
        elif whence == 1:
            self.pos += offset
        elif whence == 2:
            self.pos = len(self.data) + offset
        else:
            return -1
        self.pos = max(0, min(self.pos, len(self.data)))
        return 0

    def _tell(self, _h) -> int:
        return self.pos


def vorbis_info(source: Union[Pathlike, bytes]) -> Tuple[int, int, int]:
    """(sampling_rate, num_channels, num_samples) of an Ogg/Vorbis stream."""
    lib = _get_vorbisfile()
    if lib is None:
        raise RuntimeError("libvorbisfile not available")
    data = _as_bytes(source)
    reader = _MemReader(data)
    vf = create_string_buffer(4096)
    # datasource must be non-NULL: libvorbisfile short-circuits a NULL
    # handle to OV_ENOTVORBIS without ever invoking the callbacks.
    rc = lib.ov_open_callbacks(ctypes.c_void_p(1), vf, None, 0, reader.cb)
    if rc != 0:
        raise RuntimeError(f"ov_open_callbacks failed rc={rc}")
    try:
        vi = lib.ov_info(vf, -1).contents
        total = lib.ov_pcm_total(vf, -1)
        return int(vi.rate), int(vi.channels), max(0, int(total))
    finally:
        lib.ov_clear(vf)


def vorbis_decode(
    source: Union[Pathlike, bytes],
    offset_samples: int = 0,
    num_samples: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Decode Ogg/Vorbis to float32 (channels, samples)."""
    lib = _get_vorbisfile()
    if lib is None:
        raise RuntimeError("libvorbisfile not available")
    data = _as_bytes(source)
    reader = _MemReader(data)
    vf = create_string_buffer(4096)
    # datasource must be non-NULL: libvorbisfile short-circuits a NULL
    # handle to OV_ENOTVORBIS without ever invoking the callbacks.
    rc = lib.ov_open_callbacks(ctypes.c_void_p(1), vf, None, 0, reader.cb)
    if rc != 0:
        raise RuntimeError(f"ov_open_callbacks failed rc={rc}")
    try:
        vi = lib.ov_info(vf, -1).contents
        ch, rate = int(vi.channels), int(vi.rate)
        total = int(lib.ov_pcm_total(vf, -1))
        if offset_samples:
            if lib.ov_pcm_seek(vf, offset_samples) != 0:
                raise RuntimeError("ov_pcm_seek failed")
        want = (
            min(num_samples, max(0, total - offset_samples))
            if num_samples is not None
            else max(0, total - offset_samples)
        )
        out = np.empty((ch, want), dtype=np.float32)
        got = 0
        pcm = POINTER(POINTER(c_float))()
        bstream = c_int(0)
        while got < want:
            n = lib.ov_read_float(vf, byref(pcm), min(4096, want - got), byref(bstream))
            if n <= 0:
                break
            for c in range(ch):
                out[c, got : got + n] = np.ctypeslib.as_array(pcm[c], shape=(n,))
            got += n
        return np.ascontiguousarray(out[:, :got]), rate
    finally:
        lib.ov_clear(vf)


# --- Vorbis encode (libvorbis + libvorbisenc + libogg) ---


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", c_void_p),
        ("bytes", c_long),
        ("b_o_s", c_long),
        ("e_o_s", c_long),
        ("granulepos", c_int64),
        ("packetno", c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", c_void_p),
        ("header_len", c_long),
        ("body", c_void_p),
        ("body_len", c_long),
    ]


def _page_bytes(og: _OggPage) -> bytes:
    return (
        ctypes.string_at(og.header, og.header_len)
        + ctypes.string_at(og.body, og.body_len)
    )


_vorbis_enc_libs = None
_vorbis_enc_failed = False


def _get_vorbis_enc():
    global _vorbis_enc_libs, _vorbis_enc_failed
    if _vorbis_enc_libs is not None or _vorbis_enc_failed:
        return _vorbis_enc_libs
    vorbis = _load("libvorbis.so.0")
    venc = _load("libvorbisenc.so.2")
    ogg = _load("libogg.so.0")
    if not (vorbis and venc and ogg):
        _vorbis_enc_failed = True
        return None
    try:
        _proto_ogg(ogg)
        venc.vorbis_encode_init_vbr.restype = c_int
        venc.vorbis_encode_init_vbr.argtypes = [c_void_p, c_long, c_long, c_float]
        vorbis.vorbis_analysis_buffer.restype = POINTER(POINTER(c_float))
        vorbis.vorbis_analysis_buffer.argtypes = [c_void_p, c_int]
    except AttributeError:
        _vorbis_enc_failed = True
        return None
    _vorbis_enc_libs = (vorbis, venc, ogg)
    return _vorbis_enc_libs


def vorbis_encode_available() -> bool:
    return _get_vorbis_enc() is not None


def vorbis_encode(
    samples: np.ndarray, sampling_rate: int, quality: float = 0.4
) -> bytes:
    """Encode float32 (channels, samples) or (samples,) to Ogg/Vorbis."""
    libs = _get_vorbis_enc()
    if libs is None:
        raise RuntimeError("libvorbis/libvorbisenc/libogg not available")
    vorbis, venc, ogg = libs
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    ch, n = x.shape

    vi = create_string_buffer(512)
    vc = create_string_buffer(256)
    vd = create_string_buffer(4096)
    vb = create_string_buffer(2048)
    os_ = create_string_buffer(1024)
    vorbis.vorbis_info_init(vi)
    if venc.vorbis_encode_init_vbr(vi, ch, int(sampling_rate), c_float(quality)) != 0:
        vorbis.vorbis_info_clear(vi)
        raise RuntimeError(
            f"vorbis_encode_init_vbr failed (rate {sampling_rate}, ch {ch})")
    vorbis.vorbis_comment_init(vc)
    vorbis.vorbis_analysis_init(vd, vi)
    vorbis.vorbis_block_init(vd, vb)
    ogg.ogg_stream_init(os_, 1)

    out: List[bytes] = []
    try:
        hdr = _OggPacket()
        hdr_comm = _OggPacket()
        hdr_code = _OggPacket()
        vorbis.vorbis_analysis_headerout(
            vd, vc, byref(hdr), byref(hdr_comm), byref(hdr_code))
        for p in (hdr, hdr_comm, hdr_code):
            ogg.ogg_stream_packetin(os_, byref(p))
        og = _OggPage()
        while ogg.ogg_stream_flush(os_, byref(og)):
            out.append(_page_bytes(og))

        def drain(eos: bool):
            op = _OggPacket()
            while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                vorbis.vorbis_analysis(vb, None)
                vorbis.vorbis_bitrate_addblock(vb)
                while vorbis.vorbis_bitrate_flushpacket(vd, byref(op)) == 1:
                    ogg.ogg_stream_packetin(os_, byref(op))
                    while ogg.ogg_stream_pageout(os_, byref(og)):
                        out.append(_page_bytes(og))
            if eos:
                while ogg.ogg_stream_flush(os_, byref(og)):
                    out.append(_page_bytes(og))

        CHUNK = 4096
        for start in range(0, n, CHUNK):
            m = min(CHUNK, n - start)
            buf = vorbis.vorbis_analysis_buffer(vd, m)
            for c in range(ch):
                ctypes.memmove(
                    buf[c],
                    np.ascontiguousarray(x[c, start : start + m]).ctypes.data,
                    m * 4)
            vorbis.vorbis_analysis_wrote(vd, m)
            drain(eos=False)
        vorbis.vorbis_analysis_wrote(vd, 0)
        drain(eos=True)
        return b"".join(out)
    finally:
        ogg.ogg_stream_clear(os_)
        vorbis.vorbis_block_clear(vb)
        vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(vc)
        vorbis.vorbis_info_clear(vi)


# ===========================================================================
# Ogg/Opus — libogg (container) + libopus (codec)
# ===========================================================================

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002
_OPUS_GET_LOOKAHEAD = 4027
_OPUS_VALID_RATES = (8000, 12000, 16000, 24000, 48000)

_opus = None
_opus_failed = False


def _proto_ogg(ogg) -> None:
    """Prototype the libogg entry points we use — granulepos is 64-bit, and
    pointers must not round-trip through the default c_int."""
    ogg.ogg_sync_init.argtypes = [c_void_p]
    ogg.ogg_sync_clear.argtypes = [c_void_p]
    ogg.ogg_sync_buffer.restype = c_void_p
    ogg.ogg_sync_buffer.argtypes = [c_void_p, c_long]
    ogg.ogg_sync_wrote.argtypes = [c_void_p, c_long]
    ogg.ogg_sync_pageout.argtypes = [c_void_p, POINTER(_OggPage)]
    ogg.ogg_stream_init.argtypes = [c_void_p, c_int]
    ogg.ogg_stream_clear.argtypes = [c_void_p]
    ogg.ogg_stream_pagein.argtypes = [c_void_p, POINTER(_OggPage)]
    ogg.ogg_stream_packetout.argtypes = [c_void_p, POINTER(_OggPacket)]
    ogg.ogg_stream_packetin.argtypes = [c_void_p, POINTER(_OggPacket)]
    ogg.ogg_stream_flush.argtypes = [c_void_p, POINTER(_OggPage)]
    ogg.ogg_stream_pageout.argtypes = [c_void_p, POINTER(_OggPage)]
    ogg.ogg_page_serialno.argtypes = [POINTER(_OggPage)]
    ogg.ogg_page_bos.argtypes = [POINTER(_OggPage)]
    ogg.ogg_page_granulepos.restype = c_int64
    ogg.ogg_page_granulepos.argtypes = [POINTER(_OggPage)]


def _get_opus():
    global _opus, _opus_failed
    if _opus is not None or _opus_failed:
        return _opus
    opus = _load("libopus.so.0")
    ogg = _load("libogg.so.0")
    if not (opus and ogg):
        _opus_failed = True
        return None
    try:
        _proto_ogg(ogg)
        opus.opus_decoder_create.restype = c_void_p
        opus.opus_decoder_create.argtypes = [c_int, c_int, POINTER(c_int)]
        opus.opus_decode_float.restype = c_int
        opus.opus_decode_float.argtypes = [
            c_void_p, POINTER(c_ubyte), c_int, POINTER(c_float), c_int, c_int]
        opus.opus_decoder_destroy.argtypes = [c_void_p]
        opus.opus_encoder_create.restype = c_void_p
        opus.opus_encoder_create.argtypes = [c_int, c_int, c_int, POINTER(c_int)]
        opus.opus_encode_float.restype = c_int
        opus.opus_encode_float.argtypes = [
            c_void_p, POINTER(c_float), c_int, POINTER(c_ubyte), c_int]
        opus.opus_encoder_destroy.argtypes = [c_void_p]
    except AttributeError:
        _opus_failed = True
        return None
    _opus = (opus, ogg)
    return _opus


def opus_available() -> bool:
    return _get_opus() is not None


def _ogg_packets(ogg, data: bytes):
    """Yield (serial, packet_bytes, granulepos, eos) for every packet of the
    FIRST logical stream in an Ogg container."""
    oy = create_string_buffer(256)
    os_ = create_string_buffer(1024)
    ogg.ogg_sync_init(oy)
    ogg.ogg_sync_buffer.restype = c_void_p
    stream_init = False
    serial = None
    try:
        og = _OggPage()
        op = _OggPacket()
        pos = 0
        CHUNK = 1 << 16
        while True:
            rc = ogg.ogg_sync_pageout(oy, byref(og))
            if rc == 1:
                page_serial = ogg.ogg_page_serialno(byref(og))
                if serial is None and ogg.ogg_page_bos(byref(og)):
                    serial = page_serial
                    ogg.ogg_stream_init(os_, serial)
                    stream_init = True
                if stream_init and page_serial == serial:
                    ogg.ogg_stream_pagein(os_, byref(og))
                    granule = ogg.ogg_page_granulepos(byref(og))
                    while ogg.ogg_stream_packetout(os_, byref(op)) == 1:
                        yield (
                            serial,
                            ctypes.string_at(op.packet, op.bytes),
                            int(op.granulepos),
                            bool(op.e_o_s),
                        )
                continue
            if pos >= len(data):
                break
            m = min(CHUNK, len(data) - pos)
            buf = ogg.ogg_sync_buffer(oy, m)
            ctypes.memmove(buf, data[pos : pos + m], m)
            ogg.ogg_sync_wrote(oy, m)
            pos += m
    finally:
        if stream_init:
            ogg.ogg_stream_clear(os_)
        ogg.ogg_sync_clear(oy)


def _parse_opus_head(pkt: bytes) -> Tuple[int, int, int]:
    """OpusHead (RFC 7845 §5.1) -> (channels, preskip_48k, input_sr)."""
    if len(pkt) < 19 or pkt[:8] != b"OpusHead":
        raise RuntimeError("not an Ogg/Opus stream (OpusHead missing)")
    channels = pkt[9]
    preskip = int.from_bytes(pkt[10:12], "little")
    input_sr = int.from_bytes(pkt[12:16], "little")
    mapping_family = pkt[18]
    if mapping_family != 0:
        raise RuntimeError(
            f"Ogg/Opus mapping family {mapping_family} (surround) is not "
            f"supported by this decoder")
    return channels, preskip, input_sr


def opus_info(
    source: Union[Pathlike, bytes], force_sampling_rate: Optional[int] = None
) -> Tuple[int, int, int]:
    """(sampling_rate, channels, num_samples) of an Ogg/Opus stream. Opus
    decodes at 48 kHz by default (reference semantics: OPUS always reports
    48k unless forced)."""
    libs = _get_opus()
    if libs is None:
        raise RuntimeError("libopus/libogg not available")
    _, ogg = libs
    data = _as_bytes(source)
    rate = force_sampling_rate or 48000
    channels = None
    preskip = 0
    last_granule = 0
    for _, pkt, granule, _eos in _ogg_packets(ogg, data):
        if channels is None:
            channels, preskip, _ = _parse_opus_head(pkt)
            continue
        if granule > 0:
            last_granule = max(last_granule, granule)
    if channels is None:
        raise RuntimeError("empty Ogg/Opus stream")
    total48 = max(0, last_granule - preskip)
    n = int(round(total48 * rate / 48000))
    return rate, channels, n


def opus_decode(
    source: Union[Pathlike, bytes],
    force_sampling_rate: Optional[int] = None,
    offset_samples: int = 0,
    num_samples: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """
    Decode Ogg/Opus to float32 (channels, samples). Decodes natively at
    48 kHz, or directly at ``force_sampling_rate`` when it is one of opus's
    supported decoder rates (8/12/16/24/48 kHz); other target rates decode
    at 48 kHz and polyphase-resample (reference: read_opus_ffmpeg,
    lhotse/audio/backend.py:1494).
    """
    libs = _get_opus()
    if libs is None:
        raise RuntimeError("libopus/libogg not available")
    opus, ogg = libs
    data = _as_bytes(source)
    rate = 48000
    resample_to = None
    if force_sampling_rate:
        if force_sampling_rate in _OPUS_VALID_RATES:
            rate = int(force_sampling_rate)
        else:
            resample_to = int(force_sampling_rate)

    dec = None
    channels = None
    preskip48 = 0
    chunks: List[np.ndarray] = []
    err = c_int(0)
    pcm = None
    got_comment = False
    last_granule = 0
    try:
        for _, pkt, granule, _eos in _ogg_packets(ogg, data):
            if channels is None:
                channels, preskip48, _ = _parse_opus_head(pkt)
                dec = opus.opus_decoder_create(rate, channels, byref(err))
                if not dec:
                    raise RuntimeError(f"opus_decoder_create failed err={err.value}")
                maxf = rate * 120 // 1000
                pcm = (c_float * (maxf * channels))()
                continue
            if not got_comment:
                got_comment = True  # OpusTags
                continue
            buf = (c_ubyte * len(pkt)).from_buffer_copy(pkt)
            n = opus.opus_decode_float(dec, buf, len(pkt), pcm, rate * 120 // 1000, 0)
            if n < 0:
                raise RuntimeError(f"opus_decode_float failed rc={n}")
            if n:
                chunks.append(
                    np.ctypeslib.as_array(pcm, shape=(n * channels,))[
                        : n * channels
                    ].copy())
            if granule > 0:
                last_granule = max(last_granule, granule)
    finally:
        if dec:
            opus.opus_decoder_destroy(dec)
    if channels is None:
        raise RuntimeError("empty Ogg/Opus stream")
    flat = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    audio = flat.reshape(-1, channels).T
    preskip = int(round(preskip48 * rate / 48000))
    audio = audio[:, preskip:]
    # Granulepos-based end trim (real streams pad the final frame).
    if last_granule > 0:
        total = int(round(max(0, last_granule - preskip48) * rate / 48000))
        audio = audio[:, :total]
    if resample_to is not None:
        from lhotse_tpu_torch.augmentation.resample import resample_array

        audio = resample_array(audio, rate, resample_to)
        rate = resample_to
    if offset_samples:
        audio = audio[:, offset_samples:]
    if num_samples is not None:
        audio = audio[:, :num_samples]
    return np.ascontiguousarray(audio), rate


def _ogg_page_out(ogg, os_, out: List[bytes], flush: bool):
    og = _OggPage()
    fn = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
    while fn(os_, byref(og)):
        out.append(_page_bytes(og))


def opus_encode(
    samples: np.ndarray, sampling_rate: int, bitrate: int = 64000
) -> bytes:
    """
    Encode float32 (channels, samples) or (samples,) into an Ogg/Opus
    stream (RFC 7845). ``sampling_rate`` must be 8/12/16/24/48 kHz (opus
    codec constraint — resample first otherwise).
    """
    libs = _get_opus()
    if libs is None:
        raise RuntimeError("libopus/libogg not available")
    opus, ogg = libs
    if sampling_rate not in _OPUS_VALID_RATES:
        raise ValueError(
            f"opus encodes at {_OPUS_VALID_RATES} Hz, got {sampling_rate}")
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    ch, n = x.shape
    if ch > 2:
        raise ValueError("this encoder supports mono/stereo only")
    err = c_int(0)
    enc = opus.opus_encoder_create(sampling_rate, ch, _OPUS_APPLICATION_AUDIO, byref(err))
    if not enc:
        raise RuntimeError(f"opus_encoder_create failed err={err.value}")
    out: List[bytes] = []
    os_ = create_string_buffer(1024)
    ogg.ogg_stream_init(os_, 0x4F505553)
    try:
        # opus_encoder_ctl is variadic (no argtypes): wrap every argument
        # explicitly or the 64-bit handle is truncated to a C int.
        opus.opus_encoder_ctl(c_void_p(enc), c_int(_OPUS_SET_BITRATE), c_int(bitrate))
        lookahead = c_int(0)
        opus.opus_encoder_ctl(c_void_p(enc), c_int(_OPUS_GET_LOOKAHEAD), byref(lookahead))
        preskip48 = int(lookahead.value * 48000 / sampling_rate)

        head = (
            b"OpusHead" + bytes([1, ch])
            + int(preskip48).to_bytes(2, "little")
            + int(sampling_rate).to_bytes(4, "little")
            + b"\x00\x00" + b"\x00")
        tags = (
            b"OpusTags" + len(b"lhotse_tpu").to_bytes(4, "little")
            + b"lhotse_tpu" + (0).to_bytes(4, "little"))

        def packetin(payload: bytes, granulepos: int, packetno: int, eos: bool):
            op = _OggPacket()
            buf = (c_ubyte * max(1, len(payload))).from_buffer_copy(
                payload if payload else b"\x00")
            op.packet = cast(buf, c_void_p)
            op.bytes = len(payload)
            op.b_o_s = 1 if packetno == 0 else 0
            op.e_o_s = 1 if eos else 0
            op.granulepos = granulepos
            op.packetno = packetno
            ogg.ogg_stream_packetin(os_, byref(op))

        packetin(head, 0, 0, False)
        _ogg_page_out(ogg, os_, out, flush=True)
        packetin(tags, 0, 1, False)
        _ogg_page_out(ogg, os_, out, flush=True)

        frame = sampling_rate * 20 // 1000  # 20 ms
        total48 = preskip48
        packetno = 2
        maxbytes = 4000
        obuf = (c_ubyte * maxbytes)()
        pos = 0
        # Cover n + lookahead input samples (zero-padded) so the decoder's
        # preskip drop still leaves all n real samples; the final
        # granulepos trims the padded tail exactly.
        needed = n + int(lookahead.value)
        while pos < needed or pos == 0:
            m = max(0, min(frame, n - pos))
            block = np.zeros((frame, ch), dtype=np.float32)
            if m > 0:
                block[:m] = x[:, pos : pos + m].T
            nb = opus.opus_encode_float(
                enc,
                block.ctypes.data_as(POINTER(c_float)),
                frame, obuf, maxbytes)
            if nb < 0:
                raise RuntimeError(f"opus_encode_float failed rc={nb}")
            pos += frame
            eos = pos >= needed
            if eos:
                # Trim the zero-padded tail via the final granulepos.
                total48 = preskip48 + int(n * 48000 / sampling_rate)
            else:
                total48 += frame * 48000 // sampling_rate
            packetin(bytes(obuf[:nb]), total48, packetno, eos)
            packetno += 1
            _ogg_page_out(ogg, os_, out, flush=eos)
            if eos:
                break
        return b"".join(out)
    finally:
        ogg.ogg_stream_clear(os_)
        opus.opus_encoder_destroy(enc)


# ===========================================================================
# Container sniffing helpers for the backend registry
# ===========================================================================


def sniff_ogg_codec(head: bytes) -> Optional[str]:
    """'opus' | 'vorbis' | None from the first bytes of a file ("OggS" page
    whose first packet starts with OpusHead / \\x01vorbis)."""
    if head[:4] != b"OggS":
        return None
    # First page payload starts after the 27-byte header + segment table.
    if len(head) < 28:
        return None
    nsegs = head[26]
    payload = head[27 + nsegs :]
    if payload[:8] == b"OpusHead":
        return "opus"
    if payload[:7] == b"\x01vorbis":
        return "vorbis"
    return None


def looks_like_mp3(head: bytes) -> bool:
    if head[:3] == b"ID3":
        return True
    if len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0:
        # frame sync; check MPEG layer bits are valid (not 00)
        return (head[1] & 0x06) != 0
    return False
