"""
``command`` audio sources of the port (``lhotse_tpu_torch/audio/source.py``)
held to the JAX package's: a shell pipe whose standard output is WAV or
FLAC bytes reads the same samples as the file it pipes, whole and in part,
in both packages, with the same partial-read warning; ``AudioCache`` runs
each pipe once; a failing pipe raises.
"""
import copy
import gzip
import shutil

import numpy as np
import pytest

SR = 16000
N = SR + 1234


@pytest.fixture
def files(tmp_path):
    """A mono and a stereo WAV, a FLAC and a gzipped WAV of seeded noise."""
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.audio.wavio import write_wav

    rng = np.random.RandomState(7)
    mono = (rng.randn(N) * 0.1).astype(np.float32)
    stereo = (rng.randn(2, N) * 0.1).astype(np.float32)
    write_wav(str(tmp_path / "mono.wav"), mono, SR)
    write_wav(str(tmp_path / "stereo.wav"), stereo, SR)
    write_flac(str(tmp_path / "mono.flac"), mono, SR)
    with open(tmp_path / "mono.wav", "rb") as src, gzip.open(tmp_path / "mono.wav.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return tmp_path


@pytest.fixture
def caching_off():
    from lhotse_tpu.caching import set_caching_enabled as jax_caching
    from lhotse_tpu_torch.caching import set_caching_enabled as port_caching

    jax_caching(False)
    port_caching(False)
    yield jax_caching, port_caching
    jax_caching(False)
    port_caching(False)


def _recording(package, command, channels, num_samples):
    if package == "jax":
        from lhotse_tpu.audio import AudioSource, Recording
    else:
        from lhotse_tpu_torch.audio import AudioSource, Recording
    return Recording(
        id="piped", sources=[AudioSource(type="command", channels=channels, source=command)],
        sampling_rate=SR, num_samples=num_samples, duration=num_samples / SR)


def _file_audio(path, **kwargs):
    from lhotse_tpu_torch.audio import Recording

    return Recording.from_file(path).load_audio(**kwargs)


CASES = {
    "wav": ("cat {d}/mono.wav", [0], "mono.wav"),
    "flac": ("cat {d}/mono.flac", [0], "mono.flac"),
    "stereo_wav": ("cat {d}/stereo.wav", [0, 1], "stereo.wav"),
    "gzip_wav": ("gzip -dc {d}/mono.wav.gz", [0], "mono.wav"),
}
WINDOWS = {"whole": {}, "offset": {"offset": 0.25}, "window": {"offset": 0.125, "duration": 0.5}}


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("case", CASES)
def test_pipe_reads_equal_file_reads(files, caching_off, case, window):
    template, channels, name = CASES[case]
    kwargs = WINDOWS[window]
    command = template.format(d=files)
    loaded = {}
    for package in ("jax", "port"):
        with pytest.warns(UserWarning, match="bash command") if kwargs else _no_warning():
            loaded[package] = _recording(package, command, channels, N).load_audio(**kwargs)
    expected = _file_audio(files / name, **kwargs)
    assert loaded["port"].dtype == np.float32 and loaded["port"].shape == expected.shape
    assert np.array_equal(loaded["port"], expected)
    assert np.array_equal(loaded["port"], loaded["jax"])


class _no_warning:
    def __enter__(self):
        import warnings

        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("error", UserWarning)

    def __exit__(self, *exc):
        return self._catch.__exit__(*exc)


def test_pipe_bytes_reach_the_right_reader(files):
    """Pipe bytes reach the backend as a suffixless ``BytesIO``: the port's
    composite tells WAV from FLAC by their magic."""
    from io import BytesIO

    from lhotse_tpu_torch.audio.backend import read_audio

    for name in ("mono.wav", "mono.flac"):
        samples, sr = read_audio(BytesIO((files / name).read_bytes()))
        assert sr == SR and np.array_equal(samples, _file_audio(files / name))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_audio_cache_runs_each_pipe_once(files, caching_off, package):
    counter = files / f"runs_{package}.txt"
    command = f"echo run >> {counter}; cat {files}/mono.wav"
    rec = _recording(package, command, [0], N)
    set_caching = caching_off[0] if package == "jax" else caching_off[1]
    set_caching(True)
    first = rec.load_audio(offset=0.5, duration=0.25)
    again = rec.load_audio(offset=0.25, duration=0.5)
    whole = rec.load_audio()
    assert counter.read_text().splitlines() == ["run"]
    assert np.array_equal(whole[:, 8000:12000], first)
    assert np.array_equal(whole[:, 4000:12000], again)
    set_caching(False)
    rec.load_audio()
    rec.load_audio()
    assert counter.read_text().splitlines() == ["run"] * 3


def test_failing_pipe_raises(files, caching_off):
    command = f"cat {files}/missing.wav"
    with pytest.raises(Exception):
        _recording("jax", command, [0], N).load_audio()
    with pytest.raises(RuntimeError, match="exited with code 1.*missing.wav"):
        _recording("port", command, [0], N).load_audio()


def test_command_recording_dict_roundtrip(files, caching_off):
    """A ``command`` recording survives ``to_dict``/``from_dict`` and a
    manifest file, and the port reads the JAX package's dict."""
    from lhotse_tpu_torch.audio import Recording, RecordingSet

    command = f"cat {files}/mono.flac "
    jax_dict = _recording("jax", command, [0], N).to_dict()
    port = _recording("port", command, [0], N)
    assert port.to_dict() == jax_dict
    back = Recording.from_dict(copy.deepcopy(jax_dict))  # from_dict consumes its dict
    assert back == port and back.sources[0].type == "command"
    RecordingSet.from_recordings([port]).to_file(files / "recs.jsonl.gz")
    (read,) = list(RecordingSet.from_file(files / "recs.jsonl.gz"))
    assert read.to_dict() == jax_dict
    assert np.array_equal(read.load_audio(), _file_audio(files / "mono.flac"))


def test_shar_export_of_piped_cuts(files, caching_off, tmp_path):
    """A cut whose recording is a ``command`` source exports to Shar in the
    port, its audio equal to the piped file's. The JAX package's Shar writer
    asks every recording for its ``source_format``, which a ``command``
    source cannot give, so the same export raises there (ROADMAP C2)."""
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.shar.readers import LazySharIterator

    command = f"cat {files}/mono.flac"
    jax_cut = _recording("jax", command, [0], N).to_cut()
    from lhotse_tpu.cut import CutSet as JCutSet

    with pytest.raises(NotImplementedError, match="command"):
        JCutSet.from_cuts([jax_cut]).to_shar(tmp_path / "jax", fields={"recording": "flac"})
    cut = _recording("port", command, [0], N).to_cut()
    CutSet.from_cuts([cut]).to_shar(tmp_path / "port", fields={"recording": "flac"})
    (back,) = list(LazySharIterator(in_dir=tmp_path / "port"))
    assert np.array_equal(back.load_audio(), _file_audio(files / "mono.flac"))
    with pytest.raises(NotImplementedError, match="command"):
        CutSet.from_cuts([cut]).to_shar(tmp_path / "original", fields={"recording": "original"})
