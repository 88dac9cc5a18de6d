"""
The port's CHiME-6 array synchroniser (``lhotse_tpu_torch.recipes.chime6``:
``Chime6ArraySynchronizer``, ``verify_md5_checksums`` and
``prepare_chime6(perform_array_sync=True)``) against the JAX package's: the
ten cases of tests/test_chime6_array_sync.py run through both packages on
the same raw corpus, with every synchronised file equal byte for byte (and
its samples); a wider raw CHiME-5 layout (two dev sessions, two 4-channel
arrays and two binaural headsets each, frame drops and inserted gaps,
constant and piecewise clock-drift fits with a backwards segment) through
the synchroniser, ``prepare_chime6`` and both CLIs; the sox route's command
lines, held against JAX's with a stub ``sox`` that reports v14.4.2 and
records its arguments (neither machine has the real one); and the
downloads the port leaves out, which raise ``NotImplementedError`` naming
them.
"""
import gzip
import hashlib
import json
import os
import re
import stat

import numpy as np
import pytest

from lhotse_tpu.audio.wavio import write_wav
from lhotse_tpu.recipes import chime6 as jchime6
from lhotse_tpu_torch.audio.wavio import read_wav
from lhotse_tpu_torch.recipes import chime6 as pchime6

SR = 16000
PACKAGES = {"port": pchime6, "jax": jchime6}


@pytest.fixture
def raw_corpus(tmp_path):
    """tests/test_chime6_array_sync.py:24: one binaural headset of 400
    samples, one two-channel array of a 300-sample ramp, a dev transcript
    with a header entry and one turn."""
    root = tmp_path / "raw"
    audio = root / "audio" / "dev"
    audio.mkdir(parents=True)
    rng = np.random.default_rng(7)
    write_wav(audio / "S02_P05.wav", rng.standard_normal((2, 400)) * 0.1, SR)
    ramp = np.arange(300, dtype=np.float32) / 32768.0
    write_wav(audio / "S02_U01.CH1.wav", ramp[None, :], SR)
    write_wav(audio / "S02_U01.CH2.wav", -ramp[None, :], SR)
    trans = root / "transcriptions" / "dev"
    trans.mkdir(parents=True)
    (trans / "S02.json").write_text(json.dumps([
        {"session_id": "S02"},
        {"speaker": "P05", "start_time": {"original": "00:00:10.00"},
         "end_time": {"original": "00:00:12.00"}, "words": "hello there"}]))
    return root


EDITS = {"S02": {"U01": {"edits": [[1, 100, 1], [151, 300, 101]], "speed": 1.0, "padding": 4},
                 "P05": {"speed": 1.25, "padding": -3}}}
PIECEWISE = {"S02": {"U01": {"edits": [[1, 300, 1]], "speed": [2.0, 1.0], "padding": [0, 160]},
                     "P05": {"speed": 1.0, "padding": 0}}}
NEGATIVE_FIRST = {"S02": {"U01": {"edits": [[1, 300, 1]], "speed": [1.0, 1.0],
                                  "padding": [-40, 160]},
                          "P05": {"speed": 1.0, "padding": 0}}}
NO_HEADSET_FIT = {"S02": {"U01": {"edits": [[1, 300, 1]], "speed": 1.0, "padding": 0}}}


def _tree(directory) -> dict:
    """Every file under ``directory`` by relative path: its bytes, and for a
    WAV its samples."""
    out = {}
    for p in sorted(directory.rglob("*")):
        if p.is_file():
            rel = str(p.relative_to(directory))
            out[rel] = p.read_bytes()
            if p.suffix == ".wav":
                out[rel + ":samples"] = read_wav(p)
    return out


def _same_trees(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for key in ta:
        if key.endswith(":samples"):
            assert np.array_equal(ta[key][0], tb[key][0]) and ta[key][1] == tb[key][1], key
        else:
            assert ta[key] == tb[key], key
    return ta


def _sync_both(corpus, out_root, edits, session="S02", **kwargs):
    for pkg, module in PACKAGES.items():
        sync = module.Chime6ArraySynchronizer(corpus, out_root / pkg, audio_edits=edits, **kwargs)
        sync.synchronize_session(session)
    return _same_trees(out_root / "port", out_root / "jax")


def test_synchronize_session_native_equals_jax(raw_corpus, tmp_path):
    """tests/test_chime6_array_sync.py:61: the array's splice of samples
    1-100 and 151-300 behind 4 zeros, the headset warped to 320 samples less
    a 3-sample trim, the transcript's times moved; byte-equal to JAX's."""
    tree = _sync_both(raw_corpus, tmp_path / "synced", EDITS)
    ch1, rate = tree["audio/dev/S02_U01.CH1.wav:samples"]
    ch2, _ = tree["audio/dev/S02_U01.CH2.wav:samples"]
    assert rate == SR and ch1.shape == ch2.shape == (1, 254)
    spliced = np.concatenate([np.arange(100), np.arange(150, 300)]) / 32768.0
    np.testing.assert_allclose(ch1[0, 4:], spliced, atol=1 / 32768.0)
    np.testing.assert_allclose(ch2[0, 4:], -spliced, atol=1 / 32768.0)
    assert np.all(ch1[0, :4] == 0)
    assert tree["audio/dev/S02_P05.wav:samples"][0].shape == (2, 317)
    segs = json.loads(tree["transcriptions/dev/S02.json"])
    assert len(segs) == 1
    assert segs[0]["start_time"] == pchime6.seconds_to_hms(10.0 / 1.25 - 3 / SR)
    assert segs[0]["end_time"] == pchime6.seconds_to_hms(12.0 / 1.25 - 3 / SR)
    assert not [p for p in (tmp_path / "synced" / "port").iterdir() if p.name.startswith("chime6_")]


@pytest.mark.parametrize("channels,edits,shape", [
    (np.ones((1, 50), np.float32), [[1, 10, 1], [11, 20, 31]], (1, 40)),
    (np.ones((2, 40), np.float32), [[1, 60, 1], [61, 80, 61]], (2, 40)),
    (np.arange(24, dtype=np.int16).reshape(2, 12), [[1, 4, 1], [7, 12, 8]], (2, 13)),
])
def test_apply_edits_equals_jax(channels, edits, shape):
    """tests/test_chime6_array_sync.py:89,98: silence where no input maps,
    an edit past the input's end ignored; and an inserted gap in int16."""
    ours = pchime6.Chime6ArraySynchronizer._apply_edits(channels, edits)
    theirs = jchime6.Chime6ArraySynchronizer._apply_edits(channels, edits)
    assert ours.shape == shape and ours.dtype == channels.dtype
    assert np.array_equal(ours, theirs)
    if shape == (1, 40):
        assert np.all(ours[0, :10] == 1) and np.all(ours[0, 10:30] == 0) and np.all(ours[0, 30:] == 1)


def test_piecewise_native_warp_equals_jax(raw_corpus, tmp_path):
    """tests/test_chime6_array_sync.py:105: 160 samples at speed 2 and 140
    at speed 1 give 220."""
    tree = _sync_both(raw_corpus, tmp_path / "synced", PIECEWISE)
    assert tree["audio/dev/S02_U01.CH1.wav:samples"][0].shape == (1, 220)


def test_piecewise_negative_first_boundary_equals_jax(raw_corpus, tmp_path):
    """tests/test_chime6_array_sync.py:171: a negative first boundary trims
    40 samples and shortens the first segment to 120."""
    tree = _sync_both(raw_corpus, tmp_path / "synced", NEGATIVE_FIRST)
    ch1 = tree["audio/dev/S02_U01.CH1.wav:samples"][0]
    ramp = np.arange(300) / 32768.0
    assert ch1.shape == (1, 260)
    np.testing.assert_allclose(ch1[0, :120], ramp[40:160], atol=1 / 32768.0)
    np.testing.assert_allclose(ch1[0, 120:], ramp[160:], atol=1 / 32768.0)


def test_speaker_without_fit_keeps_original_times_as_jax(raw_corpus, tmp_path):
    """tests/test_chime6_array_sync.py:196: a headset without a fit is not
    written and its speaker keeps the original stamps."""
    tree = _sync_both(raw_corpus, tmp_path / "synced", NO_HEADSET_FIT)
    assert "audio/dev/S02_P05.wav" not in tree
    segs = json.loads(tree["transcriptions/dev/S02.json"])
    assert (segs[0]["start_time"], segs[0]["end_time"]) == ("00:00:10.00", "00:00:12.00")


def test_relative_corpus_dir_as_jax(raw_corpus, tmp_path, monkeypatch):
    """tests/test_chime6_array_sync.py:159: relative roots are resolved, so
    the headset links do not dangle."""
    monkeypatch.chdir(tmp_path)
    for pkg, module in PACKAGES.items():
        module.Chime6ArraySynchronizer("raw", f"rel_{pkg}", audio_edits=EDITS).synchronize_session(
            "S02")
    tree = _same_trees(tmp_path / "rel_port", tmp_path / "rel_jax")
    assert tree["audio/dev/S02_P05.wav:samples"][0].shape[0] == 2


def test_verify_md5_checksums_equals_jax(tmp_path):
    """tests/test_chime6_array_sync.py:123: a matching list passes, a wrong
    digest fails, unlisted files and other sessions pass."""
    corpus = tmp_path / "c"
    corpus.mkdir()
    write_wav(corpus / "S02_U01.CH1.wav", np.zeros((1, 64), dtype=np.float32), SR)
    write_wav(corpus / "S09_U02.CH1.wav", np.ones((1, 64), dtype=np.float32) * 0.5, SR)
    digest = hashlib.md5((corpus / "S02_U01.CH1.wav").read_bytes()).hexdigest()
    good, bad = tmp_path / "sums.txt", tmp_path / "bad.txt"
    good.write_text(f"{digest} S02_U01.CH1.wav\n\n")
    bad.write_text(f"{'0' * 32} S02_U01.CH1.wav\n")
    for checksum_file, sessions, want in ((good, None, True), (bad, None, False),
                                          (bad, ["S99"], True), (bad, ["S02", "S09"], False),
                                          (good, ["S09"], True)):
        for workers in (1, 3):
            got = [m.verify_md5_checksums(corpus, num_workers=workers, sessions=sessions,
                                          checksum_file=checksum_file)
                   for m in PACKAGES.values()]
            assert got == [want, want]


def test_hms_helpers_equal_jax():
    """tests/test_chime6_array_sync.py:137,142: the round trip, and the
    millisecond carry that never gives '60.000'."""
    for m in PACKAGES.values():
        assert m.seconds_to_hms(m.hms_to_seconds("01:02:03.50")) == "01:02:03.500"
        assert m.hms_to_seconds(m.seconds_to_hms(3723.5)) == 3723.5
        assert m.seconds_to_hms(59.9999) == "00:01:00.000"
        assert m.seconds_to_hms(3599.9996) == "01:00:00.000"
        assert m.seconds_to_hms(59.9994) == "00:00:59.999"
    for seconds in np.random.RandomState(148).uniform(0, 7200, 200):
        assert pchime6.seconds_to_hms(seconds) == jchime6.seconds_to_hms(seconds)


# -- a wider raw CHiME-5 layout ---------------------------------------------------------------

ARRAYS, CHANNELS, HEADSETS = ("U01", "U02"), 4, ("P05", "P06")
SESSIONS = {"S02": ("P05", "P06"), "S09": ("P25", "P26")}
WORDS = ("so", "the", "dinner", "is", "ready", "pass", "salt", "please", "thanks", "yeah")


def _hms(seconds):
    return pchime6.seconds_to_hms(seconds)


PIECE_SPEEDS = (1.0002, -1.5, 0.9998)  # the middle 300 samples fitted backwards


def _piecewise_length(length):
    """The native warp's output length of a ``length``-sample array under
    ``PIECE_SPEEDS`` at boundaries ``[-7, length // 2, length // 2 + 300]``:
    the first segment trimmed by 7, the backwards one dropped with its 200
    samples of carry taken from the third."""
    first = length // 2
    return (int((first - 7) / PIECE_SPEEDS[0])
            + int((length - int(first + 300 + 300 / 1.5)) / PIECE_SPEEDS[2]))


def chime5_tree(root, seconds=3.0, seed=6):
    """Raw CHiME-5 dev sessions S02 and S09 in the published layout: two
    4-channel arrays (``S02_U0k.CHn.wav``, each array a few hundred samples
    longer or shorter than the others) and two binaural headsets per
    session, 16-bit WAV; ``transcriptions/dev/S02.json`` with per-device
    ``original`` times, ``ref`` and ``location``; and the
    ``audio_edits.json`` shape: per array frame-drop triplets (a dropped and
    an inserted span), ``speed`` and ``padding``, the first array at speed
    1.0, the second session's second array piecewise with a backwards
    segment; per headset ``speed`` and ``padding``. Every device ends at the
    same length. Returns the corpus root and the edits."""
    rng = np.random.RandomState(seed)
    target = int(seconds * SR)
    edits = {}
    for session, headsets in SESSIONS.items():
        audio = root / "audio" / "dev"
        audio.mkdir(parents=True, exist_ok=True)
        fits = {}
        for k, array in enumerate(ARRAYS):
            drop, gap = 40 + k, 25
            piecewise = session == "S09" and k == 1
            raw = target + int(rng.randint(-300, 300))
            if piecewise:  # the raw length whose warped segments add up to the target
                raw = next(n for n in range(target - 600, target + 600)
                           if _piecewise_length(n - drop + gap) == target)
            x = (0.2 * rng.randn(CHANNELS, raw)).astype(np.float32)
            for ch in range(CHANNELS):
                write_wav(audio / f"{session}_{array}.CH{ch + 1}.wav", x[ch:ch + 1], SR)
            a = raw // 3
            splice = [[1, a, 1], [a + 1 + drop, 2 * a, a + 1], [2 * a + 1, raw, 2 * a + 1 - drop + gap]]
            length = raw - drop + gap
            if piecewise:
                first = length // 2
                fits[array] = {"edits": splice, "speed": list(PIECE_SPEEDS),
                               "padding": [-7, first, first + 300]}
                continue
            speed = 1.0 if k == 0 else float(rng.choice([0.9997, 1.0003]))
            fits[array] = {"edits": splice, "speed": speed,
                           "padding": target - int(length / speed)}
        for p in headsets:
            raw = target + int(rng.randint(-200, 200))
            write_wav(audio / f"{session}_{p}.wav", (0.1 * rng.randn(2, raw)).astype(np.float32), SR)
            speed = float(rng.choice([0.9996, 1.0, 1.0004]))
            fits[p] = {"speed": speed, "padding": target - int(raw / speed)}
        edits[session] = fits
        turns, t = [{"session_id": session}], 0.2
        while t < seconds - 0.8:
            span = float(rng.uniform(0.3, 0.8))
            spk = headsets[rng.randint(2)]
            stamps = {dev: _hms(t + 0.001 * i) for i, dev in enumerate(("original",) + ARRAYS)}
            ends = {dev: _hms(t + span + 0.001 * i) for i, dev in enumerate(("original",) + ARRAYS)}
            turns.append({"speaker": spk, "start_time": stamps, "end_time": ends,
                          "words": " ".join(WORDS[i] for i in rng.randint(0, 10, 3)),
                          "ref": ARRAYS[rng.randint(2)], "location": "kitchen"})
            t += span + float(rng.uniform(-0.2, 0.3))
        trans = root / "transcriptions" / "dev"
        trans.mkdir(parents=True, exist_ok=True)
        (trans / f"{session}.json").write_text(json.dumps(turns))
    return root, edits


def test_wide_session_sync_equals_jax(tmp_path):
    """Both sessions of the wide layout through each synchroniser: every
    file byte-equal to JAX's; each speed-1.0 array channel equal, sample by
    sample, to its edit splice behind its padding; every device of a
    session as long as the others."""
    corpus, edits = chime5_tree(tmp_path / "CHiME5")
    for session in SESSIONS:
        tree = _sync_both(corpus, tmp_path / "synced", edits, session=session, num_workers=3)
    for session in SESSIONS:
        lengths = {tree[k][0].shape[1] for k in tree
                   if k.endswith(":samples") and f"/{session}_" in k}
        assert lengths == {3 * SR}
        fit = edits[session]["U01"]
        for ch in range(CHANNELS):
            raw, _ = read_wav(corpus / "audio" / "dev" / f"{session}_U01.CH{ch + 1}.wav")
            spliced = pchime6.Chime6ArraySynchronizer._apply_edits(raw, fit["edits"])
            got = tree[f"audio/dev/{session}_U01.CH{ch + 1}.wav:samples"][0]
            pad = fit["padding"]
            want = np.pad(spliced, ((0, 0), (pad, 0))) if pad > 0 else spliced[:, -pad:]
            assert fit["speed"] == 1.0 and np.array_equal(got, want)


def _write_edits(corpus, out, edits):
    (out / "CHiME6").mkdir(parents=True)
    (out / "CHiME6" / "audio_edits.json").write_text(json.dumps(edits))


def _normalized(directory):
    out = {}
    for p in sorted(directory.glob("*.jsonl.gz")):
        out[p.name] = gzip.decompress(p.read_bytes()).replace(str(directory).encode(), b"<out>")
    return out


@pytest.mark.parametrize("mic,kwargs", [
    ("mdm", {}), ("mdm", {"use_reference_array": True, "num_jobs": 2}),
    ("ihm", {"normalize_text": "upper", "num_threads_per_job": 2})])
def test_prepare_chime6_with_array_sync_equals_jax(tmp_path, mic, kwargs):
    """``prepare_chime6(perform_array_sync=True)`` with a local
    ``CHiME6/audio_edits.json`` in each package's output directory: the
    synchronised corpus byte-equal and the manifests equal to JAX's (output
    directory swapped out); the mdm supervisions name all 8 array
    channels."""
    corpus, edits = chime5_tree(tmp_path / "CHiME5")
    made = {}
    for pkg, module in PACKAGES.items():
        _write_edits(corpus, tmp_path / pkg, edits)
        made[pkg] = module.prepare_chime6(corpus, output_dir=tmp_path / pkg, dataset_parts="dev",
                                          mic=mic, perform_array_sync=True, **kwargs)
    _same_trees(tmp_path / "port" / "CHiME6", tmp_path / "jax" / "CHiME6")
    ours, theirs = _normalized(tmp_path / "port"), _normalized(tmp_path / "jax")
    assert ours and ours == theirs
    recs, sups = made["port"]["dev"]["recordings"], made["port"]["dev"]["supervisions"]
    assert sorted(r.id for r in recs) == ["S02", "S09"]
    if mic == "mdm":
        assert all(r.num_channels == 8 for r in recs)
        if not kwargs:
            assert all(s.channel == list(range(8)) for s in sups)
        x = recs["S02"].load_audio()
        assert x.shape == (8, 3 * SR)
    else:
        assert {r.num_channels for r in recs} == {4}


def test_prepare_chime6_cli_with_array_sync(tmp_path):
    """``prepare chime6 --perform-array-sync --mic mdm`` through both CLIs
    writes what the function writes."""
    from test_torch_cli import _both as both_clis

    corpus, edits = chime5_tree(tmp_path / "CHiME5")
    for name in ("jax", "port", "function"):
        _write_edits(corpus, tmp_path / name, edits)
    runs = both_clis(tmp_path, "prepare", "chime6", corpus, "{out}", "-p", "dev", "--mic", "mdm",
                     "--perform-array-sync")
    pchime6.prepare_chime6(corpus, output_dir=tmp_path / "function", dataset_parts=["dev"],
                           mic="mdm", perform_array_sync=True)
    (pout, _), (jout, _) = runs["port"], runs["jax"]
    ours = _normalized(pout)
    assert ours and ours == _normalized(tmp_path / "function") == _normalized(jout)
    _same_trees(pout / "CHiME6", tmp_path / "function" / "CHiME6")
    _same_trees(pout / "CHiME6", jout / "CHiME6")


# -- the sox route ----------------------------------------------------------------------------

SOX_STUB = """#!{python}
import json, pathlib, shutil, sys
args = sys.argv[1:]
if args == ["--version"]:
    print("sox:      SoX v14.4.2")
    sys.exit(0)
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
files = [a for a in args if a.endswith(".wav")]
ins, out = files[:-1], files[-1]
shutil.copyfile(ins[0], out)
"""


def _sox_stub(directory):
    import sys

    directory.mkdir(parents=True, exist_ok=True)
    log = directory / "argv.jsonl"
    stub = directory / "sox"
    stub.write_text(SOX_STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return stub, log


def _argv_lines(log, out):
    """The stub's recorded command lines, the output root and the
    synchroniser's temporary directories swapped out."""
    text = log.read_text().replace(str(out), "<out>")
    text = re.sub(r"chime6_S\d\d_[A-Za-z0-9_]+", "<work>", text)
    text = re.sub(r"<out>/tmp[A-Za-z0-9_]+", "<out>/<tmp>", text)
    return [json.loads(line) for line in text.splitlines()]


def test_sox_route_command_lines_equal_jax(tmp_path):
    """With a sox that reports v14.4.2 (a stub that records its arguments and
    copies its input), each synchroniser calls it with the same command
    lines: ``-D -R``, ``speed``, ``pad``/``trim`` for constant fits, and
    ``trim``/``pad`` per segment, a ``speed`` per forward segment and the
    concatenation for piecewise fits (the backwards segment skipped)."""
    corpus, edits = chime5_tree(tmp_path / "CHiME5")
    lines = {}
    for pkg, module in PACKAGES.items():
        stub, log = _sox_stub(tmp_path / f"sox_{pkg}")
        out = tmp_path / f"synced_{pkg}"
        sync = module.Chime6ArraySynchronizer(corpus, out, sox_path=stub, audio_edits=edits)
        assert sync._sox_available()
        for session in SESSIONS:
            sync.synchronize_session(session)
        lines[pkg] = _argv_lines(log, out)
    ours = lines["port"]
    assert ours == lines["jax"]
    assert all(line[:2] == ["-D", "-R"] for line in ours)
    assert sum("speed" in line for line in ours) == 2 * (CHANNELS * 2 + 2) + CHANNELS
    assert any(line[i:i + 2] == ["trim", "7s"] for line in ours for i in range(len(line)))


def test_sox_that_fails_to_start_takes_the_native_route(tmp_path, raw_corpus):
    """A ``sox_path`` that does not run leaves both packages on the native
    warp, with byte-equal output."""
    for pkg, module in PACKAGES.items():
        sync = module.Chime6ArraySynchronizer(raw_corpus, tmp_path / pkg,
                                              sox_path=tmp_path / "no-sox", audio_edits=EDITS)
        assert not sync._sox_available()
        sync.synchronize_session("S02")
    _same_trees(tmp_path / "port", tmp_path / "jax")


# -- refusals and downloads -------------------------------------------------------------------


def test_downloads_raise_naming_them(raw_corpus, tmp_path):
    """Where the JAX package downloads the edits (no ``audio_edits`` and no
    ``audio_edits.json`` in the output directory) or the checksum list (no
    ``checksum_file``; ``prepare_chime6(verify_md5_checksums=True)`` always),
    the port raises ``NotImplementedError`` that names the download, and
    syncs nothing."""
    with pytest.raises(NotImplementedError, match="CHiME-6 audio edits.*chime6_audio_edits.json"):
        pchime6.Chime6ArraySynchronizer(raw_corpus, tmp_path / "out")
    with pytest.raises(NotImplementedError, match="CHiME-6 checksum list.*audio_md5sums.txt"):
        pchime6.verify_md5_checksums(raw_corpus)
    with pytest.raises(NotImplementedError, match="CHiME-6 checksum list"):
        pchime6.prepare_chime6(raw_corpus, output_dir=tmp_path / "o", dataset_parts="dev",
                               perform_array_sync=True, verify_md5_checksums=True)
    with pytest.raises(NotImplementedError, match="CHiME-6 audio edits"):
        pchime6.prepare_chime6(raw_corpus, output_dir=tmp_path / "o2", dataset_parts="dev",
                               perform_array_sync=True)
    assert not (tmp_path / "o").exists()
    assert not list((tmp_path / "o2").rglob("*.wav"))
    assert pchime6.CHIME6_AUDIO_EDITS_JSON == jchime6.CHIME6_AUDIO_EDITS_JSON
    assert pchime6.CHIME6_MD5SUM_FILE == jchime6.CHIME6_MD5SUM_FILE
    source = open(pchime6.__file__).read()
    assert "resumable_download" not in source and "urllib" not in source


def test_edits_from_a_file_and_the_output_directory_equal_jax(raw_corpus, tmp_path):
    """The edits given as a path, or found at ``<output_dir>/audio_edits.json``,
    give what the mapping gives, in both packages."""
    path = tmp_path / "edits.json"
    path.write_text(json.dumps(EDITS))
    for pkg, module in PACKAGES.items():
        module.Chime6ArraySynchronizer(raw_corpus, tmp_path / f"a_{pkg}",
                                       audio_edits=path).synchronize_session("S02")
        (tmp_path / f"b_{pkg}").mkdir()
        (tmp_path / f"b_{pkg}" / "audio_edits.json").write_text(json.dumps(EDITS))
        module.Chime6ArraySynchronizer(raw_corpus, tmp_path / f"b_{pkg}").synchronize_session(
            "S02")
    _sync_both(raw_corpus, tmp_path / "c", EDITS)
    a = _same_trees(tmp_path / "a_port", tmp_path / "a_jax")
    b = _same_trees(tmp_path / "b_port", tmp_path / "b_jax")
    c = _tree(tmp_path / "c" / "port")
    assert {k: v for k, v in b.items() if k != "audio_edits.json"}.keys() == a.keys() == c.keys()


def test_refusals_equal_jax(raw_corpus, tmp_path):
    """A session without edits is skipped with nothing written; a session
    without a transcript, and ``perform_array_sync`` without an output
    directory, raise the same errors in both packages."""
    errors = []
    for pkg, module in PACKAGES.items():
        sync = module.Chime6ArraySynchronizer(raw_corpus, tmp_path / pkg, audio_edits=EDITS)
        sync.synchronize_session("S09")
        assert sorted(os.listdir(tmp_path / pkg)) == []
        (raw_corpus / "transcriptions" / "dev" / "S02.json").rename(tmp_path / f"S02_{pkg}.json")
        with pytest.raises(StopIteration):
            sync.synchronize_session("S02")
        (tmp_path / f"S02_{pkg}.json").rename(raw_corpus / "transcriptions" / "dev" / "S02.json")
        with pytest.raises(ValueError) as info:
            module.prepare_chime6(raw_corpus, dataset_parts="dev", perform_array_sync=True)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert not [p for p in (tmp_path / "port").iterdir() if p.name.startswith("chime6_")]
