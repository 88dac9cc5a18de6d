"""
The port's NIST SPHERE and AIFF codecs (lhotse_tpu_torch.audio.sphio,
lhotse_tpu_torch.audio.aiffio) and their backends in the composite
(``SphereBackend``, ``AiffBackend``, ``Sph2pipeSubprocessBackend``), against
the JAX package's on the same inputs: written bytes equal, decoded arrays
``np.array_equal``, ``Recording.to_dict()`` equal.

Every input is written inside the test, into its temporary directory, from
numpy arrays made from a seed: the stereo 8 kHz SPHERE file and its WAV twin
stand in for the reference's ``stereo.sph`` fixture, which the JAX package's
own SPHERE tests read and skip without. The dispatch cases pin that each
file still reaches the backend that read it before the SPHERE and AIFF
backends joined the composite: RIFF data behind a ``.sph`` name goes to the
WAV backend and NIST data behind a ``.wav`` name to the SPHERE backend, and
a file-like object stays where it was after every probe.
"""
import io
import shutil
import struct

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio import aiffio as jaiff
from lhotse_tpu.audio import backend as jbackend
from lhotse_tpu.audio import read_sph as jread_sph_seconds
from lhotse_tpu.audio import sphio as jsph
from lhotse_tpu.audio.wavio import write_wav as jwrite_wav
from lhotse_tpu_torch.audio import Recording, RecordingSet, backend, info, read_audio, save_audio
from lhotse_tpu_torch.audio import read_sph as read_sph_seconds
from lhotse_tpu_torch.audio.aiffio import _write_extended80, info_aiff, read_aiff, write_aiff
from lhotse_tpu_torch.audio.flacio import write_flac
from lhotse_tpu_torch.audio.source import AudioSource
from lhotse_tpu_torch.audio.sphio import (
    _ALAW_TABLE, _ULAW_TABLE, SphereFormatError, SphereShortenError, _alaw_encode, _ulaw_encode,
    info_sph, read_sph, write_sph)
from lhotse_tpu_torch.audio.utils import AudioLoadingError
from lhotse_tpu_torch.audio.wavio import read_wav, write_wav

SR = 16000


def _noise(seed, channels, frames, scale=0.3):
    rng = np.random.default_rng(seed)
    return np.clip(scale * rng.standard_normal((channels, frames)), -0.99, 0.99).astype(np.float32)


def _bytes(writer, *args, **kwargs) -> bytes:
    buf = io.BytesIO()
    writer(buf, *args, **kwargs)
    return buf.getvalue()


@pytest.fixture
def stereo(tmp_path):
    """A stereo 8 kHz, 1 s SPHERE file (plain 16-bit PCM) and its WAV twin,
    written by the JAX package's writers (the port's write the same bytes,
    see ``test_write_sph_bytes_equal_jax``)."""
    x = _noise(7, 2, 8000)
    jsph.write_sph(tmp_path / "stereo.sph", x, 8000)
    jwrite_wav(tmp_path / "stereo.wav", x, 8000)
    return tmp_path / "stereo.sph", tmp_path / "stereo.wav"


# -- the stereo fixture (JAX's TestRealFixture, on an in-test file) ---------------


def test_info(stereo):
    sph, _ = stereo
    hdr = info_sph(sph)
    assert (hdr.num_channels, hdr.sampling_rate, hdr.sample_count, hdr.coding) == (2, 8000, 8000, "pcm")
    assert hdr.duration == pytest.approx(1.0)
    assert vars(hdr) == vars(jsph.info_sph(sph))


def test_decode_matches_wav_twin(stereo):
    sph, wav = stereo
    decoded, sr_s = read_sph(sph)
    with open(wav, "rb") as f:
        twin, sr_w = read_wav(f)
    assert sr_s == sr_w == 8000 and decoded.shape == twin.shape == (2, 8000)
    np.testing.assert_array_equal(decoded, twin)
    np.testing.assert_array_equal(decoded, jsph.read_sph(sph)[0])


def test_partial_read_matches_slice(stereo):
    sph, _ = stereo
    full, _ = read_sph(sph)
    part, _ = read_sph(sph, frame_offset=1000, num_frames=2000)
    np.testing.assert_array_equal(part, full[:, 1000:3000])
    np.testing.assert_array_equal(part, jsph.read_sph(sph, frame_offset=1000, num_frames=2000)[0])


def test_partial_read_clamps_at_end(stereo):
    sph, _ = stereo
    part, _ = read_sph(sph, frame_offset=7000, num_frames=5000)
    assert part.shape == (2, 1000)
    np.testing.assert_array_equal(part, jsph.read_sph(sph, frame_offset=7000, num_frames=5000)[0])


def test_file_object_input(stereo):
    sph, _ = stereo
    data = sph.read_bytes()
    samples, sr = read_sph(io.BytesIO(data))
    assert samples.shape == (2, 8000) and sr == 8000
    np.testing.assert_array_equal(samples, jsph.read_sph(io.BytesIO(data))[0])


def test_recording_from_sph(stereo):
    sph, _ = stereo
    r = Recording.from_file(sph)
    assert r.to_dict() == J.Recording.from_file(sph).to_dict()
    assert (r.num_channels, r.sampling_rate) == (2, 8000) and r.duration == pytest.approx(1.0)
    audio = r.load_audio()
    assert audio.shape == (2, 8000)
    chunk = r.load_audio(offset=0.25, duration=0.5)
    np.testing.assert_array_equal(chunk, audio[:, 2000:6000])
    np.testing.assert_array_equal(
        chunk, J.Recording.from_file(sph).load_audio(offset=0.25, duration=0.5))


# -- writing and reading back ---------------------------------------------------------


@pytest.mark.parametrize("coding,big_endian", [
    ("pcm16", False), ("pcm16", True), ("ulaw", False), ("alaw", False)])
@pytest.mark.parametrize("channels", [1, 2])
def test_write_sph_bytes_equal_jax(coding, big_endian, channels):
    x = _noise(channels, channels, 3000)
    ours = _bytes(write_sph, x, 8000, coding=coding, big_endian=big_endian)
    assert ours == _bytes(jsph.write_sph, x, 8000, coding=coding, big_endian=big_endian)
    x16 = np.round(x * 32767).astype(np.int16)
    assert _bytes(write_sph, x16, 8000, coding=coding) == _bytes(jsph.write_sph, x16, 8000, coding=coding)


@pytest.mark.parametrize("channels", [1, 2])
def test_pcm16(tmp_path, channels):
    x = _noise(0, channels, 4000)
    write_sph(tmp_path / "t.sph", x, 16000)
    y, sr = read_sph(tmp_path / "t.sph")
    assert sr == 16000
    np.testing.assert_allclose(y, x, atol=1.0 / 32768)
    np.testing.assert_array_equal(y, jsph.read_sph(tmp_path / "t.sph")[0])


def test_pcm16_big_endian(tmp_path):
    x = _noise(1, 1, 1000)
    write_sph(tmp_path / "be.sph", x, 8000, big_endian=True)
    assert info_sph(tmp_path / "be.sph").big_endian
    y, _ = read_sph(tmp_path / "be.sph")
    np.testing.assert_allclose(y, x, atol=1.0 / 32768)
    np.testing.assert_array_equal(y, jsph.read_sph(tmp_path / "be.sph")[0])


@pytest.mark.parametrize("coding,tol", [("ulaw", 0.033), ("alaw", 0.033)])
def test_companded(tmp_path, coding, tol):
    t = np.arange(8000, dtype=np.float32) / 8000.0
    x = (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)[None, :]
    p = tmp_path / f"{coding}.sph"
    write_sph(p, x, 8000, coding=coding)
    hdr = info_sph(p)
    assert hdr.coding == coding and hdr.sample_n_bytes == 1
    y, _ = read_sph(p)
    assert y.shape == x.shape and np.max(np.abs(y - x)) < tol
    assert 10 * np.log10(np.sum(x ** 2) / np.sum((y - x) ** 2)) > 30.0
    np.testing.assert_array_equal(y, jsph.read_sph(p)[0])


def test_partial_read_of_ulaw(tmp_path):
    x = _noise(2, 2, 3000)
    p = tmp_path / "u.sph"
    write_sph(p, x, 8000, coding="ulaw")
    full, _ = read_sph(p)
    part, _ = read_sph(p, frame_offset=500, num_frames=1000)
    np.testing.assert_array_equal(part, full[:, 500:1500])
    np.testing.assert_array_equal(part, jsph.read_sph(p, frame_offset=500, num_frames=1000)[0])


@pytest.mark.parametrize("n_bytes,big_endian", [(1, False), (3, False), (3, True), (4, False), (4, True)])
def test_other_pcm_widths_decode_as_jax(tmp_path, n_bytes, big_endian):
    """1-, 3- and 4-byte PCM, which neither package writes: a header and
    payload assembled here."""
    rng = np.random.default_rng(n_bytes)
    frames, channels = 500, 2
    payload = rng.integers(0, 256, size=frames * channels * n_bytes, dtype=np.uint8).tobytes()
    fmt = "10" if big_endian else "01"
    header = (b"NIST_1A\n   1024\n" + (
        f"sample_count -i {frames}\nsample_n_bytes -i {n_bytes}\nchannel_count -i {channels}\n"
        f"sample_byte_format -s{len(fmt)} {fmt}\nsample_rate -i 8000\nsample_coding -s3 pcm\n"
        "end_head\n").encode())
    p = tmp_path / "w.sph"
    p.write_bytes(header + b" " * (1024 - len(header)) + payload)
    ours, _ = read_sph(p)
    assert ours.shape == (channels, frames) and np.abs(ours).max() <= 1.0
    np.testing.assert_array_equal(ours, jsph.read_sph(p)[0])


# -- the companding tables --------------------------------------------------------------


def test_tables_equal_jax():
    np.testing.assert_array_equal(_ULAW_TABLE, jsph._ULAW_TABLE)
    np.testing.assert_array_equal(_ALAW_TABLE, jsph._ALAW_TABLE)
    x16 = np.arange(-32768, 32768, 7, dtype=np.int16)
    np.testing.assert_array_equal(_ulaw_encode(x16), jsph._ulaw_encode(x16))
    np.testing.assert_array_equal(_alaw_encode(x16), jsph._alaw_encode(x16))


def test_ulaw_codec_is_exact_inverse_on_table():
    codes = np.arange(256, dtype=np.uint8)
    recoded = _ulaw_encode(_ULAW_TABLE[codes])
    ambiguous = np.isin(codes, [0x7F, 0xFF])  # both decode to digital zero
    np.testing.assert_array_equal(recoded[~ambiguous], codes[~ambiguous])


def test_ulaw_extremes():
    assert (_ULAW_TABLE[0x00], _ULAW_TABLE[0x80], _ULAW_TABLE[0x7F], _ULAW_TABLE[0xFF]) == (
        -32124, 32124, 0, 0)


def test_alaw_monotone_by_segment():
    vals = _ALAW_TABLE[np.array([0xD5 ^ 0x80, 0xD5, 0x55])]
    assert vals[1] != vals[0]


# -- errors ----------------------------------------------------------------------------------


def test_not_a_sphere_file(tmp_path):
    p = tmp_path / "x.sph"
    p.write_bytes(b"RIFF" + b"\x00" * 100)
    with pytest.raises(SphereFormatError):
        info_sph(p)
    with pytest.raises(jsph.SphereFormatError):
        jsph.info_sph(p)


def _shorten(path):
    header = (
        b"NIST_1A\n   1024\n"
        b"sample_count -i 100\nchannel_count -i 1\nsample_rate -i 8000\n"
        b"sample_n_bytes -i 2\nsample_coding -s26 pcm,embedded-shorten-v2.00\n"
        b"end_head\n")
    path.write_bytes(header + b"\x00" * (1024 - len(header)) + b"ajkg" + b"\x00" * 50)
    return path


def test_shorten_raises_targeted_error(tmp_path, monkeypatch):
    """Shorten needs ``sph2pipe``; with none on the ``PATH`` both packages
    raise ``SphereShortenError``, from the codec and through the backend."""
    p = _shorten(tmp_path / "sh.sph")
    with pytest.raises(SphereShortenError):
        read_sph(p)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert shutil.which("sph2pipe") is None
    assert not backend.Sph2pipeSubprocessBackend.is_available()
    with pytest.raises(SphereShortenError):
        read_audio(p)
    with pytest.raises(jsph.SphereShortenError):
        jbackend.read_audio(p)
    # The header still probes: the manifest is the JAX package's.
    assert Recording.from_file(p).to_dict() == J.Recording.from_file(p).to_dict()


def test_truncated_payload(tmp_path):
    p = tmp_path / "t.sph"
    write_sph(p, np.zeros((1, 1000), dtype=np.float32), 8000)
    p.write_bytes(p.read_bytes()[: 1024 + 500])
    with pytest.raises(SphereFormatError, match="truncated"):
        read_sph(p)
    with pytest.raises(jsph.SphereFormatError, match="truncated"):
        jsph.read_sph(p)


def test_mislabeled_riff_behind_sph_suffix(tmp_path):
    p = tmp_path / "fake.sph"
    write_wav(p, np.zeros((1, 800), dtype=np.float32), 8000)
    assert not backend.SphereBackend().handles_special_case(p)
    r = Recording.from_file(p)
    assert r.load_audio().shape == (1, 800) and r.to_dict() == J.Recording.from_file(p).to_dict()


def test_offset_duration_seconds(tmp_path):
    x = (np.sin(np.arange(16000) / 30.0) * 0.4).astype(np.float32)[None, :]
    p = tmp_path / "a.sph"
    write_sph(p, x, 8000)
    full, sr = read_sph_seconds(p)
    assert sr == 8000 and full.shape == (1, 16000)
    part, _ = read_sph_seconds(p, offset=0.5, duration=1.0)
    np.testing.assert_array_equal(part, full[:, 4000:12000])
    tail, _ = read_sph_seconds(p, offset=1.5)
    np.testing.assert_array_equal(tail, full[:, 12000:])
    for kw in (dict(), dict(offset=0.5, duration=1.0), dict(offset=1.5)):
        np.testing.assert_array_equal(read_sph_seconds(p, **kw)[0], jread_sph_seconds(p, **kw)[0])


# -- AIFF (JAX's test_aiff_audio.py) ------------------------------------------------------------


def _build_aifc(frames, compression: bytes, payload: bytes, bits: int, ch=1):
    """An AIFF-C file assembled by hand with the given SSND payload."""
    comm = (struct.pack(">HIH", ch, frames, bits) + _write_extended80(float(SR)) + compression
            + b"\x0bcompression")
    if len(comm) & 1:
        comm += b"\x00"
    chunks = b""
    for cid, body in ((b"FVER", struct.pack(">I", 0xA2805140)), (b"COMM", comm),
                      (b"SSND", struct.pack(">II", 0, 0) + payload)):
        chunks += cid + struct.pack(">I", len(body)) + body + (b"\x00" if len(body) & 1 else b"")
    form = b"AIFC" + chunks
    return b"FORM" + struct.pack(">I", len(form)) + form


@pytest.fixture
def sig():
    t = np.arange(SR) / SR
    return (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


def _same_as_jax(blob_or_path, ours):
    theirs = jaiff.read_aiff(blob_or_path)
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[0], theirs[0])


def test_aiff_write_read_roundtrip(tmp_path, sig):
    write_aiff(tmp_path / "x.aiff", sig, SR)
    assert (tmp_path / "x.aiff").read_bytes() == _bytes(jaiff.write_aiff, sig, SR)
    out, sr = read_aiff(tmp_path / "x.aiff")
    assert sr == SR and out.shape == (1, SR)
    np.testing.assert_allclose(out[0], sig, atol=2.0 ** -15)
    _same_as_jax(tmp_path / "x.aiff", (out, sr))
    hdr = info_aiff(tmp_path / "x.aiff")
    assert (hdr.num_channels, hdr.sampling_rate, hdr.num_frames) == (1, SR, SR)
    assert vars(hdr) == vars(jaiff.info_aiff(tmp_path / "x.aiff"))


def test_aiff_stereo_roundtrip(tmp_path):
    x = _noise(0, 2, 5000, scale=0.1)
    write_aiff(tmp_path / "st.aif", x, SR)
    out, _ = read_aiff(tmp_path / "st.aif")
    assert out.shape == (2, 5000)
    np.testing.assert_allclose(out, x, atol=2.0 ** -15)
    _same_as_jax(tmp_path / "st.aif", (out, SR))


@pytest.mark.parametrize("rate", [8000, 11025, 22050, 44100, 48000, 96000])
def test_extended80_equals_jax(rate):
    assert _write_extended80(float(rate)) == jaiff._write_extended80(float(rate))
    assert jaiff._read_extended80(_write_extended80(float(rate))) == rate


def test_aifc_sowt_little_endian(sig):
    pcm = np.clip(np.rint(sig * 32768), -32768, 32767).astype("<i2")
    blob = _build_aifc(SR, b"sowt", pcm.tobytes(), bits=16)
    out = read_aiff(blob)
    np.testing.assert_allclose(out[0][0], sig, atol=2.0 ** -15)
    _same_as_jax(blob, out)


def test_aifc_fl32(sig):
    blob = _build_aifc(SR, b"fl32", sig.astype(">f4").tobytes(), bits=32)
    out = read_aiff(blob)
    np.testing.assert_array_equal(out[0][0], sig)
    _same_as_jax(blob, out)


def test_aifc_fl64(sig):
    blob = _build_aifc(SR, b"fl64", sig.astype(">f8").tobytes(), bits=64)
    out = read_aiff(blob)
    np.testing.assert_allclose(out[0][0], sig, atol=1e-7)
    _same_as_jax(blob, out)


@pytest.mark.parametrize("compression", [b"ulaw", b"alaw"])
def test_aifc_companded(sig, compression):
    from lhotse_tpu_torch.audio.wavio import alaw_table, mulaw_table

    table = (mulaw_table if compression == b"ulaw" else alaw_table)()
    quiet = (sig * 0.1).astype(np.float32)
    codes = np.abs(quiet[:, None] - table[None, :]).argmin(axis=1).astype(np.uint8)
    blob = _build_aifc(SR, compression, codes.tobytes(), bits=16)
    out = read_aiff(blob)
    np.testing.assert_allclose(out[0][0], quiet, atol=5e-3)
    _same_as_jax(blob, out)


@pytest.mark.parametrize("bits", [8, 24, 32])
def test_pcm_widths_big_endian(sig, bits):
    vals = np.clip(np.rint(sig * (1 << (bits - 1))), -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    vals = vals.astype(np.int64)
    raw = b"".join(int(v).to_bytes(bits // 8, "big", signed=True) for v in vals[:4000])
    comm = struct.pack(">HIH", 1, 4000, bits) + _write_extended80(float(SR))
    chunks = b""
    for cid, body in ((b"COMM", comm), (b"SSND", struct.pack(">II", 0, 0) + raw)):
        chunks += cid + struct.pack(">I", len(body)) + body + (b"\x00" if len(body) & 1 else b"")
    blob = b"FORM" + struct.pack(">I", len(b"AIFF" + chunks)) + b"AIFF" + chunks
    out = read_aiff(blob)
    np.testing.assert_allclose(out[0][0], sig[:4000], atol=2.0 ** -(bits - 1))
    _same_as_jax(blob, out)


def test_aiff_backend_dispatch_and_recording(tmp_path, sig):
    write_aiff(tmp_path / "r.aiff", sig, SR)
    rec = Recording.from_file(tmp_path / "r.aiff")
    assert rec.to_dict() == J.Recording.from_file(tmp_path / "r.aiff").to_dict()
    assert rec.sampling_rate == SR and rec.num_samples == SR
    np.testing.assert_allclose(rec.load_audio()[0], sig, atol=2.0 ** -15)
    part = rec.load_audio(offset=0.25, duration=0.5)
    np.testing.assert_array_equal(part, rec.load_audio()[:, SR // 4: SR // 4 + SR // 2])
    np.testing.assert_array_equal(
        part, J.Recording.from_file(tmp_path / "r.aiff").load_audio(offset=0.25, duration=0.5))


def test_aiff_rejects_non_aiff():
    with pytest.raises(ValueError, match="AIFF"):
        read_aiff(b"RIFF" + b"\x00" * 40)
    with pytest.raises(ValueError, match="AIFF"):
        jaiff.read_aiff(b"RIFF" + b"\x00" * 40)


# -- the composite: order, dispatch, file-likes, saving ---------------------------------------------


def test_composite_order_is_jax():
    names = [type(b).__name__ for b in backend.get_default_audio_backend().backends]
    jnames = [type(b).__name__ for b in jbackend.get_default_audio_backend().backends]
    assert names[:4] == ["SphereBackend", "InternalWavBackend", "FlacBackend", "AiffBackend"]
    # The lossy backends follow where their system libraries load, in JAX's order.
    assert jnames[:len(names)] == names


def _corpus(tmp_path):
    """One 2-channel signal in every container the port reads, under each
    suffix it claims, each written by the port's writers."""
    x = _noise(3, 2, 4000)
    files = {}
    for name in ("a.sph", "a.wv1", "a.wv2", "a.WAV.sph"):
        write_sph(tmp_path / name, x, SR)
        files[name] = "SphereBackend"
    write_sph(tmp_path / "ulaw.sph", x, SR, coding="ulaw")
    files["ulaw.sph"] = "SphereBackend"
    for name in ("a.aif", "a.aiff", "a.aifc"):
        write_aiff(tmp_path / name, x, SR)
        files[name] = "AiffBackend"
    write_wav(tmp_path / "a.wav", x, SR)
    files["a.wav"] = "InternalWavBackend"
    write_flac(str(tmp_path / "a.flac"), x, SR)
    files["a.flac"] = "FlacBackend"
    write_wav(tmp_path / "riff.sph", x, SR)  # RIFF behind a SPHERE name
    files["riff.sph"] = "InternalWavBackend"
    write_sph(tmp_path / "nist.wav", x, SR)  # NIST behind a WAV name, as TIMIT ships it
    files["nist.wav"] = "SphereBackend"
    write_sph(tmp_path / "NIST.WAV", x, SR)
    files["NIST.WAV"] = "SphereBackend"
    return files


def _reader_of(composite, path_or_fd) -> str:
    """The backend the composite hands ``path_or_fd`` to."""
    special = [b for b in composite.backends if b.handles_special_case(path_or_fd)]
    if special:
        return type(special[0]).__name__
    for b in composite.backends:
        if b.is_applicable(path_or_fd):
            return type(b).__name__


def test_dispatch_pins_both_directions(tmp_path):
    composite = backend.get_default_audio_backend()
    jcomposite = jbackend.get_default_audio_backend()
    for name, want in _corpus(tmp_path).items():
        path = tmp_path / name
        assert _reader_of(composite, path) == want == _reader_of(jcomposite, path), name
        r = Recording.from_file(path)
        assert r.to_dict() == J.Recording.from_file(path).to_dict(), name
        np.testing.assert_array_equal(r.load_audio(), J.Recording.from_file(path).load_audio())
        assert info(path) == tuple(jbackend.info(path))
    assert not backend.SphereBackend().handles_special_case(tmp_path / "riff.sph")
    assert backend.SphereBackend().handles_special_case(tmp_path / "nist.wav")


def test_dispatch_of_the_formats_read_before(tmp_path):
    """WAV and FLAC, under their names and by their magic in a file-like,
    still reach the backends that read them before SPHERE and AIFF joined."""
    composite = backend.get_default_audio_backend()
    files = _corpus(tmp_path)
    for name in ("a.wav", "a.flac", "riff.sph"):
        assert _reader_of(composite, tmp_path / name) == files[name]
        assert _reader_of(composite, io.BytesIO((tmp_path / name).read_bytes())) == files[name]


def test_probes_leave_file_likes_in_place(tmp_path):
    files = _corpus(tmp_path)
    probes = [backend.SphereBackend(), backend.InternalWavBackend(), backend.FlacBackend(),
              backend.AiffBackend(), backend.Sph2pipeSubprocessBackend()]
    for name in files:
        fd = io.BytesIO(b"junk" + (tmp_path / name).read_bytes())
        fd.seek(4)
        for b in probes:
            b.handles_special_case(fd)
            assert fd.tell() == 4, (name, type(b).__name__)
            b.is_applicable(fd)
            assert fd.tell() == 4, (name, type(b).__name__)


@pytest.mark.parametrize("name", ["a.sph", "ulaw.sph", "a.aiff", "nist.wav"])
def test_file_likes_and_memory_sources(tmp_path, name):
    """SPHERE and AIFF from a ``BytesIO`` and from a ``memory``
    ``AudioSource`` (what Shar readers hand the composite), against JAX."""
    _corpus(tmp_path)
    data = (tmp_path / name).read_bytes()
    ours, sr = read_audio(io.BytesIO(data))
    theirs, jsr = jbackend.read_audio(io.BytesIO(data))
    assert sr == jsr == SR
    np.testing.assert_array_equal(ours, theirs)
    part, _ = read_audio(io.BytesIO(data), offset=0.05, duration=0.1)
    np.testing.assert_array_equal(part, jbackend.read_audio(io.BytesIO(data), offset=0.05, duration=0.1)[0])
    rec = Recording.from_bytes(data, recording_id="m")
    jrec = J.Recording.from_bytes(data, recording_id="m")
    assert rec.to_dict() == jrec.to_dict() and rec.sources[0].type == "memory"
    np.testing.assert_array_equal(rec.load_audio(), jrec.load_audio())
    np.testing.assert_array_equal(rec.load_audio(offset=0.1), jrec.load_audio(offset=0.1))
    source = AudioSource(type="memory", channels=[0, 1], source=data)
    np.testing.assert_array_equal(source.load_audio(), ours)


def test_from_dir_equals_jax(tmp_path):
    x = _noise(4, 1, 8000)
    for i in range(3):
        write_sph(tmp_path / f"utt{i}.sph", x[:, : 4000 + 1000 * i], SR, coding=("pcm16", "ulaw", "alaw")[i])
        write_aiff(tmp_path / f"utt{i}.aiff", x[:, : 3000 + 1000 * i], SR)
    for pattern in ("*.sph", "*.aiff"):
        ours = RecordingSet.from_dir(tmp_path, pattern)
        theirs = J.RecordingSet.from_dir(tmp_path, pattern)
        assert sorted((r.to_dict() for r in ours), key=lambda d: d["id"]) == sorted(
            (r.to_dict() for r in theirs), key=lambda d: d["id"])
        assert len(ours) == 3


@pytest.mark.parametrize("fmt,encoding", [("sph", None), ("sph", "ULAW"), ("sph", "ALAW"), ("wv1", None)])
def test_save_sph_equals_jax(tmp_path, fmt, encoding):
    x = _noise(5, 2, 2000)
    save_audio(tmp_path / f"ours.{fmt}", x, SR, encoding=encoding)
    jbackend.save_audio(tmp_path / f"jax.{fmt}", x, SR, encoding=encoding)
    assert (tmp_path / f"ours.{fmt}").read_bytes() == (tmp_path / f"jax.{fmt}").read_bytes()
    assert _bytes(save_audio, x, SR, format=fmt, encoding=encoding) == _bytes(
        jbackend.save_audio, x, SR, format=fmt, encoding=encoding)


@pytest.mark.parametrize("fmt", ["aiff", "aif", "aifc"])
def test_save_aiff_writes_aiff(tmp_path, fmt):
    """The port writes AIFF where the JAX composite hands the format to its
    first saving backend, SPHERE: a NIST file under the AIFF name, which the
    JAX package then cannot read back (ROADMAP C1). The port's bytes are the
    JAX AIFF writer's, and both packages read them back."""
    x = _noise(6, 2, 2000)
    save_audio(tmp_path / f"ours.{fmt}", x, SR)
    assert (tmp_path / f"ours.{fmt}").read_bytes() == _bytes(jaiff.write_aiff, x, SR)
    assert _bytes(save_audio, x, SR, format=fmt) == _bytes(jaiff.write_aiff, x, SR)
    np.testing.assert_array_equal(Recording.from_file(tmp_path / f"ours.{fmt}").load_audio(),
                                  J.Recording.from_file(tmp_path / f"ours.{fmt}").load_audio())
    jbackend.save_audio(tmp_path / f"jax.{fmt}", x, SR)
    assert (tmp_path / f"jax.{fmt}").read_bytes()[:7] == b"NIST_1A"
    with pytest.raises(J.audio.AudioLoadingError):
        J.Recording.from_file(tmp_path / f"jax.{fmt}")


def test_pinned_raises_stay(tmp_path):
    x = _noise(8, 1, 1000)
    for fmt in ("m4a", "wma"):
        with pytest.raises(NotImplementedError, match=fmt):
            save_audio(tmp_path / f"x.{fmt}", x, SR)
        with pytest.raises(NotImplementedError):
            save_audio(io.BytesIO(), x, SR, format=fmt)
    # A 'url' source reads through open_best, as the JAX package's does: a
    # path that is no file raises the same error in both.
    url = dict(type="url", channels=[0], source="cat x.wav")
    with pytest.raises(Exception) as ours:
        AudioSource(**url).load_audio()
    with pytest.raises(Exception) as theirs:
        J.AudioSource(**url).load_audio()
    assert (type(ours.value), str(ours.value)) == (type(theirs.value), str(theirs.value))
    # The lossy codecs and ``compress`` are ported: a SPHERE recording
    # compresses as the JAX package's does.
    write_sph(tmp_path / "a.sph", x, SR)
    # So are ``command`` sources: a pipe of the SPHERE file reads as the file
    # does, in both packages.
    command = dict(type="command", channels=[0], source=f"cat {tmp_path / 'a.sph'}")
    piped = AudioSource(**command).load_audio()
    np.testing.assert_array_equal(piped, Recording.from_file(tmp_path / "a.sph").load_audio())
    np.testing.assert_array_equal(piped, J.AudioSource(**command).load_audio())
    assert Recording.from_file(tmp_path / "a.sph").compress().to_dict() == J.Recording.from_file(
        tmp_path / "a.sph").compress().to_dict()


def test_unreadable_input_raises_audio_loading_error(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"\x01\x02" * 64)
    with pytest.raises(AudioLoadingError):
        read_audio(p)
