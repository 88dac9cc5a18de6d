"""
The port's lossy system codecs (lhotse_tpu_torch.audio.syscodecs: MP3
through libmpg123/libmp3lame, Ogg/Vorbis through libvorbisfile and
libvorbisenc, Ogg/Opus through libogg and libopus) and their backends in the
composite (``Mpg123Backend``, ``OggOpusBackend``, ``OggVorbisBackend``),
against the JAX package's on the same inputs.

Both packages call the same C libraries with the same arguments, so the
checks are exact: encoded bytes equal, decoded arrays ``np.array_equal``,
``*_info`` and ``Recording.to_dict()`` equal. Every input is made inside
the test from a numpy seed; no test reads a fixture directory.
"""
import io

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio import aiffio as jaiff
from lhotse_tpu.audio import backend as jbackend
from lhotse_tpu.audio import syscodecs as jsc
from lhotse_tpu_torch.audio import Recording, info, read_audio, save_audio
from lhotse_tpu_torch.audio import backend
from lhotse_tpu_torch.audio import syscodecs as sc
from lhotse_tpu_torch.audio.source import AudioSource

pytestmark = pytest.mark.skipif(
    not (jsc.mp3_available() and jsc.mp3_encode_available() and jsc.vorbis_available()
         and jsc.vorbis_encode_available() and jsc.opus_available()),
    reason="the system codec libraries (mpg123, mp3lame, vorbis, opus, ogg) are not present")


def _signal(seed, channels, sr, seconds=0.5):
    """Two tones and a little noise, as lossy codecs see speech-like input."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    rows = [0.3 * np.sin(2 * np.pi * (220.0 + 170.0 * c) * t) + 0.05 * rng.standard_normal(t.size)
            for c in range(channels)]
    return np.clip(np.stack(rows), -0.99, 0.99).astype(np.float32)


def _bytes(writer, *args, **kwargs) -> bytes:
    buf = io.BytesIO()
    writer(buf, *args, **kwargs)
    return buf.getvalue()


def _equal_decodes(ours, theirs):
    assert ours[1] == theirs[1]
    assert ours[0].dtype == theirs[0].dtype == np.float32
    np.testing.assert_array_equal(ours[0], theirs[0])


def test_all_libraries_load_and_are_named():
    assert (sc.mp3_available(), sc.mp3_encode_available(), sc.vorbis_available(),
            sc.vorbis_encode_available(), sc.opus_available()) == (True,) * 5
    assert sc.loaded_sonames() == {
        name: True for name in ("libmpg123.so.0", "libmp3lame.so.0", "libvorbisfile.so.3",
                                "libvorbis.so.0", "libvorbisenc.so.2", "libogg.so.0",
                                "libopus.so.0")}


# -- MP3 ----------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sr,kbps", [(16000, 64), (22050, 96), (44100, 128), (48000, 192)])
def test_mp3_encode_bytes_and_decode_equal_jax(channels, sr, kbps):
    x = _signal(sr + channels, channels, sr)
    data = sc.mp3_encode(x, sr, bitrate_kbps=kbps)
    assert data == jsc.mp3_encode(x, sr, bitrate_kbps=kbps)
    _equal_decodes(sc.mp3_decode(data), jsc.mp3_decode(data))
    decoded, rate = sc.mp3_decode(data)
    # The LAME tag makes mpg123's gapless decode give back the input's length.
    assert rate == sr and decoded.shape == x.shape
    assert sc.mp3_info(data) == jsc.mp3_info(data) == (sr, channels, x.shape[1])


def test_mp3_mono_input_as_1d_equals_jax():
    x = _signal(3, 1, 16000)[0]
    assert sc.mp3_encode(x, 16000) == jsc.mp3_encode(x, 16000)


@pytest.mark.parametrize("offset,num", [(0, None), (1234, None), (0, 2000), (4321, 1500)])
def test_mp3_partial_reads_equal_jax(tmp_path, offset, num):
    x = _signal(11, 2, 48000, seconds=0.4)
    path = tmp_path / "a.mp3"
    path.write_bytes(jsc.mp3_encode(x, 48000))
    for src in (path, str(path), path.read_bytes()):
        _equal_decodes(sc.mp3_decode(src, offset_samples=offset, num_samples=num),
                       jsc.mp3_decode(src, offset_samples=offset, num_samples=num))
    assert sc.mp3_info(path) == jsc.mp3_info(path)


def test_mp3_bad_input_as_jax():
    with pytest.raises(ValueError, match="at most 2 channels"):
        sc.mp3_encode(_signal(1, 3, 16000), 16000)
    with pytest.raises(ValueError, match="at most 2 channels"):
        jsc.mp3_encode(_signal(1, 3, 16000), 16000)
    # Bytes with no frame decode to nothing, in both packages.
    _equal_decodes(sc.mp3_decode(b"\x00" * 64), jsc.mp3_decode(b"\x00" * 64))
    assert sc.mp3_decode(b"\x00" * 64)[0].shape == (1, 0)


# -- Ogg/Vorbis -----------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sr,quality", [(16000, -0.1), (16000, 0.4), (44100, 0.9), (48000, 0.5)])
def test_vorbis_encode_bytes_and_decode_equal_jax(channels, sr, quality):
    x = _signal(sr + 7 * channels, channels, sr)
    data = sc.vorbis_encode(x, sr, quality=quality)
    assert data == jsc.vorbis_encode(x, sr, quality=quality)
    _equal_decodes(sc.vorbis_decode(data), jsc.vorbis_decode(data))
    assert sc.vorbis_decode(data)[0].shape == x.shape
    assert sc.vorbis_info(data) == jsc.vorbis_info(data) == (sr, channels, x.shape[1])


@pytest.mark.parametrize("offset,num", [(0, 3000), (5000, None), (4097, 4097), (7999, 50)])
def test_vorbis_seek_reads_equal_jax(tmp_path, offset, num):
    x = _signal(5, 2, 16000)
    path = tmp_path / "a.ogg"
    path.write_bytes(jsc.vorbis_encode(x, 16000))
    for src in (path, path.read_bytes()):
        _equal_decodes(sc.vorbis_decode(src, offset_samples=offset, num_samples=num),
                       jsc.vorbis_decode(src, offset_samples=offset, num_samples=num))


# -- Ogg/Opus ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("sr,bitrate", [(8000, 16000), (12000, 24000), (16000, 32000),
                                        (24000, 64000), (48000, 128000)])
def test_opus_encode_bytes_and_decode_equal_jax(channels, sr, bitrate):
    x = _signal(sr + channels, channels, sr)
    data = sc.opus_encode(x, sr, bitrate=bitrate)
    assert data == jsc.opus_encode(x, sr, bitrate=bitrate)
    # Opus decodes at 48 kHz unless told otherwise, and at the native rates.
    _equal_decodes(sc.opus_decode(data), jsc.opus_decode(data))
    assert sc.opus_decode(data)[1] == 48000
    _equal_decodes(sc.opus_decode(data, force_sampling_rate=sr),
                   jsc.opus_decode(data, force_sampling_rate=sr))
    assert sc.opus_decode(data, force_sampling_rate=sr)[0].shape == x.shape
    assert sc.opus_info(data) == jsc.opus_info(data)
    assert sc.opus_info(data, force_sampling_rate=sr) == (sr, channels, x.shape[1])


@pytest.mark.parametrize("rate", [22050, 44100, 11025])
def test_opus_non_native_rate_resamples_as_jax(rate):
    """A rate the decoder does not take decodes at 48 kHz and goes through
    the port's ``resample_array`` (held equal to JAX's)."""
    data = jsc.opus_encode(_signal(9, 2, 16000), 16000)
    _equal_decodes(sc.opus_decode(data, force_sampling_rate=rate),
                   jsc.opus_decode(data, force_sampling_rate=rate))
    assert sc.opus_info(data, force_sampling_rate=rate) == jsc.opus_info(
        data, force_sampling_rate=rate)


@pytest.mark.parametrize("offset,num", [(100, None), (0, 777), (3000, 2000)])
def test_opus_partial_reads_equal_jax(offset, num):
    data = jsc.opus_encode(_signal(4, 1, 16000), 16000)
    for rate in (None, 16000, 22050):
        _equal_decodes(
            sc.opus_decode(data, force_sampling_rate=rate, offset_samples=offset, num_samples=num),
            jsc.opus_decode(data, force_sampling_rate=rate, offset_samples=offset,
                            num_samples=num))


@pytest.mark.parametrize("rate", [44100, 22050, 32000])
def test_opus_rate_error_raised_as_jax(rate):
    x = _signal(2, 1, rate)
    with pytest.raises(ValueError) as ours:
        sc.opus_encode(x, rate)
    with pytest.raises(ValueError) as theirs:
        jsc.opus_encode(x, rate)
    assert str(ours.value) == str(theirs.value)


def test_opus_rejects_other_streams_as_jax():
    vorbis = jsc.vorbis_encode(_signal(1, 1, 16000), 16000)
    with pytest.raises(RuntimeError) as ours:
        sc.opus_decode(vorbis)
    with pytest.raises(RuntimeError) as theirs:
        jsc.opus_decode(vorbis)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="mono/stereo"):
        sc.opus_encode(_signal(1, 3, 16000), 16000)


# -- sniffers ---------------------------------------------------------------------------


def test_sniffers_equal_jax():
    x = _signal(8, 1, 16000, seconds=0.2)
    heads = [jsc.mp3_encode(x, 16000)[:320], jsc.vorbis_encode(x, 16000)[:320],
             jsc.opus_encode(x, 16000)[:320], b"ID3\x04" + bytes(316), b"\xff\xfb\x90\x00",
             b"\xff\xf9\x00\x00", b"\xff\xe0", b"OggS" + bytes(30), b"OggS", b"RIFF0000WAVE",
             b"fLaC", b"", b"\xff"]
    for head in heads:
        assert sc.sniff_ogg_codec(head) == jsc.sniff_ogg_codec(head)
        assert sc.looks_like_mp3(head) == jsc.looks_like_mp3(head)
    assert [sc.sniff_ogg_codec(h) for h in heads[:3]] == [None, "vorbis", "opus"]
    assert [sc.looks_like_mp3(h) for h in heads[:3]] == [True, False, False]


# -- the composite ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def lossy_files(tmp_path_factory):
    """A 48 kHz mono MP3 (a CommonVoice clip's shape), a stereo 44.1 kHz
    Vorbis ``.ogg``, a 16 kHz Opus ``.opus`` and the same Opus stream behind
    an ``.ogg`` name, written by the JAX package's encoders."""
    root = tmp_path_factory.mktemp("lossy")
    files = {
        "clip.mp3": jsc.mp3_encode(_signal(21, 1, 48000, seconds=0.7), 48000),
        "stereo.ogg": jsc.vorbis_encode(_signal(22, 2, 44100, seconds=0.6), 44100),
        "speech.opus": jsc.opus_encode(_signal(23, 1, 16000, seconds=0.9), 16000),
        "speech_opus.ogg": jsc.opus_encode(_signal(24, 2, 16000, seconds=0.5), 16000),
    }
    for name, data in files.items():
        (root / name).write_bytes(data)
    return root


FILES = ["clip.mp3", "stereo.ogg", "speech.opus", "speech_opus.ogg"]


def test_lossy_backends_join_the_composite_in_jax_order():
    ours = [type(b).__name__ for b in backend.get_default_audio_backend().backends]
    theirs = [type(b).__name__ for b in jbackend.get_default_audio_backend().backends]
    assert ours == [n for n in theirs if n not in ("SoundfileBackend", "FfmpegSubprocessBackend")]
    assert ours[-3:] == ["Mpg123Backend", "OggOpusBackend", "OggVorbisBackend"]


@pytest.mark.parametrize("name", FILES)
@pytest.mark.parametrize("force", [None, 16000, 22050])
def test_recording_from_file_and_load_equal_jax(lossy_files, name, force):
    path = lossy_files / name
    ours = Recording.from_file(path, force_opus_sampling_rate=force)
    theirs = J.Recording.from_file(path, force_opus_sampling_rate=force)
    assert ours.to_dict() == theirs.to_dict()
    assert info(path, force_opus_sampling_rate=force) == jbackend.info(
        path, force_opus_sampling_rate=force)
    np.testing.assert_array_equal(ours.load_audio(), theirs.load_audio())
    np.testing.assert_array_equal(ours.load_audio(offset=0.15, duration=0.2),
                                  theirs.load_audio(offset=0.15, duration=0.2))
    assert ours.load_audio().shape == (ours.num_channels, ours.num_samples)


@pytest.mark.parametrize("name", FILES)
@pytest.mark.parametrize("offset,duration", [(0.0, None), (0.1, 0.25), (0.33, None)])
def test_read_audio_window_equal_jax(lossy_files, name, offset, duration):
    path = lossy_files / name
    for force in (None, 16000):
        ours = read_audio(path, offset=offset, duration=duration, force_opus_sampling_rate=force)
        theirs = jbackend.read_audio(path, offset=offset, duration=duration,
                                     force_opus_sampling_rate=force)
        _equal_decodes(ours, theirs)


@pytest.mark.parametrize("name", FILES)
def test_members_without_suffix_are_sniffed(lossy_files, name):
    """A Shar member or ``memory`` source has no suffix: the composite sniffs
    its first bytes, and a file-like object stays where it was."""
    data = (lossy_files / name).read_bytes()
    fd = io.BytesIO(data)
    _equal_decodes(read_audio(fd, force_opus_sampling_rate=16000),
                   jbackend.read_audio(io.BytesIO(data), force_opus_sampling_rate=16000))
    assert fd.tell() == 0
    src = AudioSource(type="memory", channels=[0], source=data)
    jsrc = J.AudioSource(type="memory", channels=[0], source=data)
    np.testing.assert_array_equal(src.load_audio(force_opus_sampling_rate=16000),
                                  jsrc.load_audio(force_opus_sampling_rate=16000))


@pytest.mark.parametrize("fmt", ["mp3", "ogg", "vorbis", "oga", "opus"])
@pytest.mark.parametrize("channels", [1, 2])
def test_save_audio_bytes_equal_jax(tmp_path, fmt, channels):
    x = _signal(31 + channels, channels, 16000)
    ours, theirs = tmp_path / f"ours.{fmt}", tmp_path / f"jax.{fmt}"
    save_audio(ours, x, 16000)
    jbackend.save_audio(theirs, x, 16000)
    assert ours.read_bytes() == theirs.read_bytes()
    assert _bytes(save_audio, x, 16000, format=fmt) == _bytes(jbackend.save_audio, x, 16000,
                                                               format=fmt)
    if fmt in ("mp3", "opus", "ogg"):
        back = Recording.from_file(ours, force_opus_sampling_rate=16000)
        assert back.to_dict() == J.Recording.from_file(
            ours, force_opus_sampling_rate=16000).to_dict()
        assert (back.sampling_rate, back.num_channels, back.num_samples) == (16000, channels, 8000)


def test_aiff_still_writes_aiff(tmp_path):
    """The lossy routes leave the port's repair in place: ``.aiff`` writes
    AIFF (the JAX composite writes NIST SPHERE there)."""
    x = _signal(41, 1, 16000)
    save_audio(tmp_path / "a.aiff", x, 16000)
    assert (tmp_path / "a.aiff").read_bytes() == _bytes(jaiff.write_aiff, x, 16000)
    jbackend.save_audio(tmp_path / "j.aiff", x, 16000)
    assert (tmp_path / "j.aiff").read_bytes()[:7] == b"NIST_1A"


def test_unknown_format_still_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="m4a"):
        save_audio(tmp_path / "a.m4a", _signal(1, 1, 16000), 16000)


# -- Shar shards in opus and mp3 ----------------------------------------------------------


@pytest.fixture(scope="module")
def wav_cuts(tmp_path_factory):
    """Six 16 kHz WAV utterances of 0.3-0.8 s with a supervision each, as a
    manifest the JAX package wrote."""
    from lhotse_tpu.audio.wavio import write_wav as jwrite_wav

    root = tmp_path_factory.mktemp("shar_lossy")
    cuts = []
    for i in range(6):
        jwrite_wav(str(root / f"u{i}.wav"), _signal(50 + i, 1, 16000, 0.3 + 0.1 * i), 16000)
        cut = J.Recording.from_file(root / f"u{i}.wav").to_cut()
        cut.supervisions.append(J.SupervisionSegment(
            id=f"s{i}", recording_id=cut.recording_id, start=0.0, duration=cut.duration,
            text="lossy"))
        cuts.append(cut)
    J.CutSet.from_cuts(cuts).to_file(root / "cuts.jsonl")
    return root


@pytest.mark.parametrize("fmt", ["opus", "mp3"])
def test_shar_lossy_members_equal_jax(wav_cuts, tmp_path, fmt):
    """``to_shar`` with the recording field in opus or mp3 writes tars
    byte-equal to the JAX package's; the streaming reader decodes each
    member from memory, sniffed, to ``decode(encode(source))`` of its cut."""
    import tarfile

    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.shar.readers import LazySharIterator

    out = {}
    for pkg, cls in (("port", CutSet), ("jax", J.CutSet)):
        out[pkg] = cls.from_file(wav_cuts / "cuts.jsonl").to_shar(
            tmp_path / pkg, fields={"recording": fmt}, shard_size=4, compress_jsonl=False)
    tars = sorted(p.name for p in (tmp_path / "jax").glob("recording.*.tar"))
    assert len(tars) == 2 and tars == sorted(p.name for p in (tmp_path / "port").glob("*.tar"))
    for name in tars:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        with tarfile.open(tmp_path / "port" / name) as tar:
            assert all(m.name.endswith(f".{fmt}") for m in tar.getmembers()
                       if not m.name.endswith(".json"))
    ours = list(LazySharIterator(in_dir=tmp_path / "port"))
    theirs = list(J.CutSet.from_shar(in_dir=tmp_path / "jax"))
    sources = {c.id: c for c in J.CutSet.from_file(wav_cuts / "cuts.jsonl")}
    assert [c.id for c in ours] == [c.id for c in theirs] == list(sources)
    for o, t in zip(ours, theirs):
        audio = o.load_audio()
        np.testing.assert_array_equal(audio, t.load_audio())
        x = sources[o.id].load_audio()
        if fmt == "opus":
            want, _ = sc.opus_decode(sc.opus_encode(x, 16000), force_sampling_rate=16000)
        else:
            want, _ = sc.mp3_decode(sc.mp3_encode(x, 16000))
        np.testing.assert_array_equal(audio, want)
        assert o.supervisions[0].text == "lossy"
