"""
Kaldi data-dir interop of the port (``lhotse_tpu_torch/kaldi.py``) held to
the JAX package's (``lhotse_tpu/kaldi.py``): every case of
``tests/test_kaldi_interop.py`` run through both packages, plus the helpers.
Manifests must be equal as ``to_dict()``, exported Kaldi files byte for
byte, audio read through pipes ``np.array_equal``. Both packages read the
same audio files; each writes into a directory of its own.
"""
import filecmp
from types import SimpleNamespace

import numpy as np
import pytest

SR = 16000
KALDI_FILES = ("wav.scp", "segments", "text", "utt2spk", "utt2dur", "reco2dur", "utt2lang",
               "utt2gender")


def _jax():
    from lhotse_tpu import Recording, RecordingSet, SupervisionSegment, SupervisionSet
    from lhotse_tpu import kaldi
    from lhotse_tpu.audio import AudioSource
    from lhotse_tpu.bin.modes import cli
    from lhotse_tpu.utils import fastcopy

    return SimpleNamespace(Recording=Recording, RecordingSet=RecordingSet,
                           SupervisionSegment=SupervisionSegment, SupervisionSet=SupervisionSet,
                           AudioSource=AudioSource, kaldi=kaldi, cli=cli, fastcopy=fastcopy)


def _port():
    from lhotse_tpu_torch import kaldi
    from lhotse_tpu_torch.audio import AudioSource, Recording, RecordingSet
    from lhotse_tpu_torch.bin.modes import cli
    from lhotse_tpu_torch.supervision import SupervisionSegment, SupervisionSet
    from lhotse_tpu_torch.utils import fastcopy

    return SimpleNamespace(Recording=Recording, RecordingSet=RecordingSet,
                           SupervisionSegment=SupervisionSegment, SupervisionSet=SupervisionSet,
                           AudioSource=AudioSource, kaldi=kaldi, cli=cli, fastcopy=fastcopy)


PACKAGES = {"jax": _jax, "port": _port}


def _dicts(manifest):
    return None if manifest is None else [item.to_dict() for item in manifest]


def _write_wav(path, data):
    from lhotse_tpu_torch.audio.wavio import write_wav

    write_wav(str(path), np.asarray(data, np.float32), SR)


@pytest.fixture
def audio_dir(tmp_path):
    """Three 2 s noise WAVs, written once for both packages."""
    rng = np.random.RandomState(0)
    d = tmp_path / "audio"
    d.mkdir()
    for i in range(3):
        _write_wav(d / f"rec{i}.wav", rng.randn(SR * 2) * 0.1)
    return d


def _manifests(pkg, audio_dir):
    recs, sups = [], []
    for i in range(3):
        r = pkg.Recording.from_file(audio_dir / f"rec{i}.wav", recording_id=f"rec{i}")
        recs.append(r)
        sups.append(pkg.SupervisionSegment(
            id=f"utt{i}", recording_id=r.id, start=0.25, duration=1.5, channel=0,
            text=f"hello {i}", speaker=f"spk{i % 2}", language="English", gender="male"))
    return pkg.RecordingSet.from_recordings(recs), pkg.SupervisionSet.from_segments(sups)


def _same_dir(a, b, names=KALDI_FILES):
    for name in names:
        assert (a / name).is_file() == (b / name).is_file(), name
        if (a / name).is_file():
            assert filecmp.cmp(a / name, b / name, shallow=False), name


def _load_both(data_dir, **kwargs):
    out = {}
    for name, make in PACKAGES.items():
        pkg = make()
        recs, sups, feats = pkg.kaldi.load_kaldi_data_dir(data_dir, sampling_rate=SR, **kwargs)
        out[name] = (recs, sups, feats)
    (jr, js, jf), (tr, ts, tf) = out["jax"], out["port"]
    assert _dicts(jr) == _dicts(tr)
    assert _dicts(js) == _dicts(ts)
    assert jf is None and tf is None
    return out


def test_export_import_roundtrip(audio_dir, tmp_path):
    for name, make in PACKAGES.items():
        pkg = make()
        make_recs, make_sups = _manifests(pkg, audio_dir)
        pkg.kaldi.export_to_kaldi(make_recs, make_sups, tmp_path / name)
    for name in KALDI_FILES:
        assert (tmp_path / "port" / name).is_file(), f"missing {name}"
    _same_dir(tmp_path / "jax", tmp_path / "port")
    out = _load_both(tmp_path / "port")
    jax_audio = next(iter(out["jax"][0])).load_audio()
    port_audio = next(iter(out["port"][0])).load_audio()
    assert port_audio.shape == (1, SR * 2)
    assert np.array_equal(jax_audio, port_audio)


def test_import_without_segments(audio_dir, tmp_path):
    pkg = _port()
    data_dir = tmp_path / "kaldi_data2"
    pkg.kaldi.export_to_kaldi(*_manifests(pkg, audio_dir), data_dir)
    (data_dir / "segments").unlink()
    (data_dir / "text").write_text("".join(f"rec{i} hi {i}\n" for i in range(3)))
    (data_dir / "utt2spk").write_text("".join(f"rec{i} spk{i % 2}\n" for i in range(3)))
    out = _load_both(data_dir)
    assert len(out["port"][1]) == 3
    assert all(s.start == 0.0 for s in out["port"][1])


def test_cli_kaldi_roundtrip(audio_dir, tmp_path):
    from click.testing import CliRunner

    for name, make in PACKAGES.items():
        pkg = make()
        recs, sups = _manifests(pkg, audio_dir)
        d = tmp_path / name
        d.mkdir()
        recs.to_file(d / "recordings.jsonl.gz")
        sups.to_file(d / "supervisions.jsonl.gz")
        runner = CliRunner()
        res = runner.invoke(pkg.cli, ["kaldi", "export", str(d / "recordings.jsonl.gz"),
                                      str(d / "supervisions.jsonl.gz"), str(d / "kdir")])
        assert res.exit_code == 0, res.output
        res = runner.invoke(pkg.cli, ["kaldi", "import", str(d / "kdir"), str(SR), str(d / "mdir")])
        assert res.exit_code == 0, res.output
    _same_dir(tmp_path / "jax" / "kdir", tmp_path / "port" / "kdir")
    port = _port()
    for manifest in ("recordings.jsonl.gz", "supervisions.jsonl.gz"):
        assert not (tmp_path / "port" / "mdir" / "features.jsonl.gz").exists()
        a = port.RecordingSet if manifest.startswith("rec") else port.SupervisionSet
        assert (_dicts(a.from_file(tmp_path / "jax" / "mdir" / manifest))
                == _dicts(a.from_file(tmp_path / "port" / "mdir" / manifest)))


def _pipe_dir(tmp_path, audio, reco2dur=True):
    wav = tmp_path / "p0.wav"
    _write_wav(wav, audio)
    data_dir = tmp_path / "kdir"
    data_dir.mkdir()
    (data_dir / "wav.scp").write_text(f"p0 cat {wav} |\n")
    (data_dir / "utt2spk").write_text("p0 spkA\n")
    (data_dir / "text").write_text("p0 hello\n")
    if reco2dur:
        (data_dir / "reco2dur").write_text(f"p0 {len(audio) / SR}\n")
    return wav, data_dir


def test_wav_scp_pipe_entries_become_command_sources(tmp_path):
    """A ``wav.scp`` line that ends in ``|`` is a ``command`` source in both
    packages, with the space before the ``|`` kept, and its audio equals the
    file's."""
    audio = np.random.RandomState(1).randn(SR) * 0.1
    wav, data_dir = _pipe_dir(tmp_path, audio)
    out = _load_both(data_dir)
    loaded = {}
    for name, (recs, sups, _) in out.items():
        rec = recs["p0"]
        assert rec.sources[0].type == "command"
        assert rec.sources[0].source == f"cat {wav} "
        assert sups["p0"].speaker == "spkA"
        loaded[name] = rec.load_audio()
    from lhotse_tpu_torch.audio import Recording

    assert loaded["port"].shape == (1, SR)
    assert np.array_equal(loaded["port"], loaded["jax"])
    assert np.array_equal(loaded["port"], Recording.from_file(wav).load_audio())


def test_durations_read_from_reco2dur_without_decoding(tmp_path):
    data_dir = tmp_path / "kdir2"
    data_dir.mkdir()
    (data_dir / "wav.scp").write_text("u0 sox -n -t wav - synth 2 sine 300 |\n")
    (data_dir / "utt2spk").write_text("u0 spk\n")
    (data_dir / "reco2dur").write_text("u0 2.5\n")
    out = _load_both(data_dir)
    assert out["port"][0]["u0"].duration == pytest.approx(2.5)


def test_segments_end_minus_one_runs_to_recording_end(tmp_path):
    wav = tmp_path / "e0.wav"
    _write_wav(wav, 0.05 * np.ones(2 * SR))
    data_dir = tmp_path / "kdir3"
    data_dir.mkdir()
    (data_dir / "wav.scp").write_text(f"e0 {wav}\n")
    (data_dir / "segments").write_text("e0-utt e0 0.5 -1\ne0-utt2 e0 0.25 1.0\n")
    (data_dir / "utt2spk").write_text("e0-utt spk\ne0-utt2 spk\n")
    (data_dir / "text").write_text("e0-utt words\ne0-utt2 more words\n")
    (data_dir / "reco2dur").write_text("e0 2.0\n")
    out = _load_both(data_dir)
    seg = out["port"][1]["e0-utt"]
    assert seg.start == pytest.approx(0.5)
    assert seg.duration == pytest.approx(1.5)


def test_map_string_to_underscores(tmp_path):
    wav = tmp_path / "m0.wav"
    _write_wav(wav, 0.05 * np.ones(SR))
    data_dir = tmp_path / "kdir4"
    data_dir.mkdir()
    (data_dir / "wav.scp").write_text(f"m0 {wav}\n")
    (data_dir / "segments").write_text("spk-a-m0-utt m0 0.0 0.5\n")
    (data_dir / "utt2spk").write_text("spk-a-m0-utt spk-a\n")
    (data_dir / "text").write_text("spk-a-m0-utt words\n")
    out = _load_both(data_dir, map_string_to_underscores="-")
    (sup,) = list(out["port"][1])
    assert sup.id == "spk_a_m0_utt" and sup.speaker == "spk_a"


@pytest.mark.parametrize("package", ["jax", "port"])
def test_load_kaldi_text_mapping_and_text_file(tmp_path, package):
    kaldi = PACKAGES[package]().kaldi
    p = tmp_path / "utt2spk"
    p.write_text("a spk1\nb spk2\n\n")
    assert kaldi.load_kaldi_text_mapping(p) == {"a": "spk1", "b": "spk2"}
    missing = kaldi.load_kaldi_text_mapping(tmp_path / "nope")
    assert missing == {} and missing["x"] is None
    with pytest.raises(ValueError, match="No such file"):
        kaldi.load_kaldi_text_mapping(tmp_path / "nope", must_exist=True)
    (tmp_path / "reco2dur").write_text("a 1.5\nb 2\n")
    assert kaldi.load_kaldi_text_mapping(tmp_path / "reco2dur", float_vals=True) == {"a": 1.5, "b": 2.0}

    t = tmp_path / "text"
    t.write_text("a hello world\nb\n")
    assert kaldi.load_kaldi_text_file(t, allow_empty_ref=True) == {"a": "hello world", "b": ""}
    with pytest.raises(ValueError, match="Empty ref"):
        kaldi.load_kaldi_text_file(t, allow_empty_ref=False)
    with pytest.raises(ValueError, match="No such file"):
        kaldi.load_kaldi_text_file(tmp_path / "nope")

    kaldi.save_kaldi_text_mapping({"b": 2.5, "a": "x y"}, tmp_path / "saved")
    assert (tmp_path / "saved").read_text() == "a x y\nb 2.5\n"


def test_export_multichannel_recording_splits_channels(tmp_path):
    """Kaldi has no multi-channel wav.scp entry: both packages write one
    line per channel, with the same ``ffmpeg`` channel pick."""
    data = np.stack([0.05 * np.ones(SR), -0.05 * np.ones(SR)])
    p = tmp_path / "st.wav"
    _write_wav(p, data)
    for name, make in PACKAGES.items():
        pkg = make()
        rec = pkg.Recording.from_file(p, recording_id="st")
        sups = pkg.SupervisionSet.from_segments([pkg.SupervisionSegment(
            id="st-utt", recording_id="st", start=0.0, duration=1.0, channel=[0, 1], text="x",
            speaker="s")])
        pkg.kaldi.export_to_kaldi(pkg.RecordingSet.from_recordings([rec]), sups, tmp_path / name)
    _same_dir(tmp_path / "jax", tmp_path / "port")
    scp = (tmp_path / "port" / "wav.scp").read_text()
    assert len(scp.strip().splitlines()) == 2
    assert "-map_channel 0.0.1" in scp
    assert (tmp_path / "port" / "segments").read_text().splitlines() == [
        "st-utt-0 st_0 0.0 1.0", "st-utt-1 st_1 0.0 1.0"]


def test_export_options_and_gender_asymmetry(audio_dir, tmp_path):
    """``map_underscores_to`` and ``prefix_spk_id`` write the same files in
    both packages. Export writes ``utt2gender`` and import reads
    ``spk2gender``, so a round trip loses the gender in both."""
    for name, make in PACKAGES.items():
        pkg = make()
        recs, sups = _manifests(pkg, audio_dir)
        sups = pkg.SupervisionSet.from_segments(
            pkg.fastcopy(s, speaker=f"spk_{s.speaker}") for s in sups)
        pkg.kaldi.export_to_kaldi(recs, sups, tmp_path / name, map_underscores_to="-",
                                  prefix_spk_id=True)
    _same_dir(tmp_path / "jax", tmp_path / "port")
    assert (tmp_path / "port" / "utt2spk").read_text().startswith("spk-spk0-utt0 spk-spk0\n")
    assert not (tmp_path / "port" / "spk2gender").exists()
    out = _load_both(tmp_path / "port")
    assert all(s.gender is None for s in out["port"][1])


def _string_map_cases(tmp_path):
    return [
        ("wav", dict(type="file", channels=[0], source=str(tmp_path / "a.wav")), None),
        ("wav_transforms", dict(type="file", channels=[0], source=str(tmp_path / "a.wav")),
         [{"name": "Speed", "kwargs": {"factor": 1.1}}]),
        ("flac", dict(type="file", channels=[0], source=str(tmp_path / "a.flac")), None),
        ("sph", dict(type="file", channels=[0, 1], source=str(tmp_path / "a.sph")), None),
        ("command", dict(type="command", channels=[0], source="cat a.wav"), None),
        ("multi", dict(type="file", channels=[0, 1, 2], source=str(tmp_path / "m.wav")), None),
    ]


@pytest.mark.parametrize("case", range(6))
def test_make_wavscp_channel_string_map(tmp_path, case):
    name, source, transforms = _string_map_cases(tmp_path)[case]
    maps = {}
    for pkg_name, make in PACKAGES.items():
        pkg = make()
        maps[pkg_name] = pkg.kaldi.make_wavscp_channel_string_map(
            pkg.AudioSource(**source), sampling_rate=8000, transforms=transforms)
    assert maps["jax"] == maps["port"]
    assert sorted(maps["port"]) == source["channels"] or name == "command"
    if name in ("flac", "multi", "wav_transforms"):
        assert all(v.startswith("ffmpeg -threads 1 -i") and v.endswith("|")
                   for v in maps["port"].values())
    if name == "sph":
        assert maps["port"][1].startswith(f"sph2pipe {source['source']} -f wav -c 2 -p | ffmpeg")


@pytest.mark.parametrize("source", [
    dict(type="url", channels=[0], source="https://example.com/a.wav"),
    dict(type="command", channels=[0, 1], source="cat a.wav"),
    dict(type="memory", channels=[0], source=b"RIFF"),
])
def test_make_wavscp_channel_string_map_refusals(source):
    messages = []
    for make in PACKAGES.values():
        pkg = make()
        with pytest.raises(ValueError) as err:
            pkg.kaldi.make_wavscp_channel_string_map(pkg.AudioSource(**source), sampling_rate=SR)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("value", [0.0, 1.0, 1.2345678, 2.9999, 3.0005, 123.4569999])
def test_floor_duration_to_milliseconds(value):
    jax_kaldi, port_kaldi = _jax().kaldi, _port().kaldi
    assert port_kaldi.floor_duration_to_milliseconds(value) == (
        jax_kaldi.floor_duration_to_milliseconds(value))


def test_get_duration(tmp_path):
    wav = tmp_path / "d.wav"
    _write_wav(wav, np.zeros(12345))
    for make in PACKAGES.values():
        kaldi = make().kaldi
        assert kaldi.get_duration(wav) == 0.771
        assert kaldi.get_duration(tmp_path / "missing.wav") is None


def test_pipe_needs_reco2dur_without_kaldi_native_io(tmp_path):
    """Without ``reco2dur``, a pipe's duration needs ``kaldi_native_io``,
    which neither package finds: both raise the same ``ValueError``."""
    from lhotse_tpu_torch.utils import is_module_available

    assert not is_module_available("kaldi_native_io")
    _, data_dir = _pipe_dir(tmp_path, np.zeros(SR), reco2dur=False)
    messages = []
    for make in PACKAGES.values():
        kaldi = make().kaldi
        with pytest.raises(ValueError) as err:
            kaldi.load_kaldi_data_dir(data_dir, sampling_rate=SR)
        messages.append(str(err.value))
        with pytest.raises(ValueError):
            kaldi.get_duration("cat x.wav |")
    assert messages[0] == messages[1] and "kaldi_native_io" in messages[0]


def test_feats_scp_ignored_without_kaldi_native_io(tmp_path):
    wav = tmp_path / "f0.wav"
    _write_wav(wav, 0.05 * np.ones(SR))
    data_dir = tmp_path / "kdir5"
    data_dir.mkdir()
    (data_dir / "wav.scp").write_text(f"f0 {wav}\n")
    (data_dir / "segments").write_text("f0-utt f0 0.0 0.5\n")
    (data_dir / "utt2spk").write_text("f0-utt spk\n")
    (data_dir / "text").write_text("f0-utt words\n")
    (data_dir / "feats.scp").write_text("f0-utt feats.ark:12\n")
    out = _load_both(data_dir, frame_shift=0.01)
    assert len(out["port"][1]) == 1
    port = _port().kaldi
    assert port.load_start_and_duration(data_dir / "segments", data_dir / "feats.scp", 0.01) == {}


def test_reco2dur_length_mismatch_and_unreadable_audio(tmp_path):
    wav = tmp_path / "g0.wav"
    _write_wav(wav, 0.05 * np.ones(SR))
    data_dir = tmp_path / "kdir6"
    data_dir.mkdir()
    (data_dir / "wav.scp").write_text(f"g0 {wav}\ng1 {tmp_path / 'missing.wav'}\n")
    (data_dir / "reco2dur").write_text("g0 1.0\n")
    for make in PACKAGES.values():
        kaldi = make().kaldi
        with pytest.raises(AssertionError, match="reco2dur"):
            kaldi.load_kaldi_data_dir(data_dir, sampling_rate=SR)
        with pytest.raises(RuntimeError, match="more than 20%"):
            kaldi.load_kaldi_data_dir(data_dir, sampling_rate=SR, use_reco2dur=False)


def test_cli_import_compute_durations_flag(tmp_path):
    """``kaldi import -d`` ignores a wrong reco2dur and reads the audio, in
    both CLIs."""
    from click.testing import CliRunner

    wav = tmp_path / "u0.wav"
    _write_wav(wav, 0.05 * np.ones(SR))
    kdir = tmp_path / "kdir"
    kdir.mkdir()
    (kdir / "wav.scp").write_text(f"u0 {wav}\n")
    (kdir / "utt2spk").write_text("u0 spkA\n")
    (kdir / "reco2dur").write_text("u0 7.5\n")
    durations = {}
    for name, make in PACKAGES.items():
        pkg = make()
        for flag in ([], ["-d"]):
            out = tmp_path / f"{name}{''.join(flag)}"
            res = CliRunner().invoke(pkg.cli, ["kaldi", "import", *flag, str(kdir), str(SR), str(out)])
            assert res.exit_code == 0, res.output
            durations[(name, tuple(flag))] = pkg.RecordingSet.from_file(
                out / "recordings.jsonl.gz")["u0"].duration
    assert durations[("port", ())] == durations[("jax", ())] == 7.5
    assert durations[("port", ("-d",))] == durations[("jax", ("-d",))] == 1.0
