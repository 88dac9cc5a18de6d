"""
The port's activity-detection workflow
(``lhotse_tpu_torch/workflows/activity_detection``) and its CLI command
``workflows activity-detection`` against the JAX package's, on the same
seeded recordings: tone bursts separated by near-silence. The energy VAD
is host numpy in float64 in both packages, so its spans must be equal
exactly (one flipped frame moves an edge). The Silero detectors get one
stub ``torch.hub.load`` for both packages (a deterministic fake model and
``get_speech_timestamps``): no test reaches the hub.
"""
import gzip
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import lhotse_tpu as J
from lhotse_tpu.audio.backend import save_audio as jsave_audio
from lhotse_tpu.bin.modes import cli as jcli
from lhotse_tpu.workflows import activity_detection as JAD
from lhotse_tpu_torch.audio import RecordingSet
from lhotse_tpu_torch.bin.modes import cli as pcli
from lhotse_tpu_torch.workflows import activity_detection as PAD

SR = 16000


def _bursts(rng, seconds: float, channels: int = 1, sr: int = SR) -> np.ndarray:
    """Tone bursts of 0.3-1.5 s separated by 0.1-0.8 s of near-silence."""
    n = int(seconds * sr)
    out = np.zeros((channels, n), np.float32)
    for c in range(channels):
        pos = int(rng.uniform(0.05, 0.4) * sr)
        while pos < n:
            length = int(rng.uniform(0.3, 1.5) * sr)
            t = np.arange(min(length, n - pos)) / sr
            out[c, pos:pos + t.size] = 0.4 * np.sin(2 * np.pi * rng.uniform(150, 600) * t)
            pos += t.size + int(rng.uniform(0.1, 0.8) * sr)
        out[c] += 1e-4 * rng.standard_normal(n).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five recordings written by the JAX package: three mono FLACs of 3-6 s
    at 16 kHz, a two-channel WAV and an 8 kHz mono WAV; their manifest."""
    root = tmp_path_factory.mktemp("vad")
    rng = np.random.default_rng(35)
    specs = [("a", "flac", 1, SR), ("b", "flac", 1, SR), ("c", "flac", 1, SR),
             ("d", "wav", 2, SR), ("e", "wav", 1, 8000)]
    for name, fmt, channels, sr in specs:
        jsave_audio(root / f"{name}.{fmt}", _bursts(rng, rng.uniform(3, 6), channels, sr), sr)
    recordings = J.RecordingSet.from_recordings(
        J.Recording.from_file(root / f"{name}.{fmt}") for name, fmt, _, _ in specs)
    recordings.to_file(root / "recordings.jsonl.gz")
    return root, recordings, RecordingSet.from_dicts([r.to_dict() for r in recordings])


def _dicts(items) -> list:
    return [s.to_dict() for s in items]


@pytest.mark.parametrize("kwargs", [
    {}, {"threshold": 0.05}, {"min_duration": 0.6}, {"min_pause": 0.5, "frame_size": 0.05},
    {"frame_shift": 0.02}])
def test_detect_activity_energy_single_equals_jax(corpus, kwargs):
    _, jrecs, precs = corpus
    found = 0
    for ours, theirs in zip(precs, jrecs):
        spans = PAD.detect_activity_energy_single(ours, **kwargs)
        assert _dicts(spans) == _dicts(JAD.detect_activity_energy_single(theirs, **kwargs))
        found += len(spans)
    assert found > 5


@pytest.mark.parametrize("num_jobs", [1, 2])
def test_detect_activity_energy_equals_jax(corpus, num_jobs):
    _, jrecs, precs = corpus
    ours = PAD.detect_activity_energy(precs, threshold=0.02, num_jobs=num_jobs)
    theirs = JAD.detect_activity_energy(jrecs, threshold=0.02, num_jobs=1)
    assert _dicts(ours) == _dicts(theirs) and len(ours) > 5


@pytest.mark.parametrize("sampling_rate", [16000, 8000])
def test_energy_vad_detector_equals_jax(corpus, sampling_rate):
    """Per channel, after resampling to the detector's rate; the device is
    accepted and not used."""
    _, jrecs, precs = corpus
    ours = PAD.EnergyVAD(sampling_rate=sampling_rate, device="cuda", threshold=0.02)
    theirs = JAD.EnergyVAD(sampling_rate=sampling_rate, threshold=0.02)
    assert ours.device == "cuda" and PAD.EnergyVAD().device == "cpu"
    PAD.EnergyVAD.force_download()
    channels = set()
    for orec, jrec in zip(precs, jrecs):
        sups = ours(orec)
        assert _dicts(sups) == _dicts(theirs(jrec))
        channels |= {s.channel for s in sups}
    assert channels == {0, 1}


def test_energy_vad_forward_edges_equal_jax():
    """Short, silent and single-frame tracks, and a track active to its end."""
    ours, theirs = PAD.EnergyVAD(), JAD.EnergyVAD()
    rng = np.random.default_rng(4)
    tracks = [np.zeros(100, np.float32), np.zeros(SR, np.float32),
              rng.standard_normal(400).astype(np.float32),
              np.concatenate([np.zeros(SR // 2), rng.standard_normal(SR)]).astype(np.float32)]
    for track in tracks:
        assert ([a.__dict__ for a in ours.forward(track)]
                == [a.__dict__ for a in theirs.forward(track)])


# -- Silero through one stub hub -----------------------------------------------------------------


class _FakeSilero:
    """A deterministic stand-in for the Silero model: it remembers the
    devices it was moved to."""

    def __init__(self):
        self.devices = []

    def to(self, device):
        self.devices.append(str(device))
        return self


def _fake_timestamps(wav, model, sampling_rate, return_seconds=False):
    """Speech where the 512-sample block's peak exceeds 0.1, as sample spans."""
    x = wav.detach().cpu().numpy()
    block = 512
    loud = [np.abs(x[i:i + block]).max() > 0.1 for i in range(0, x.size, block)]
    spans, start = [], None
    for k, on in enumerate(loud + [False]):
        if on and start is None:
            start = k * block
        elif not on and start is not None:
            spans.append({"start": start, "end": min(k * block, x.size)})
            start = None
    return spans


@pytest.fixture
def stub_hub(monkeypatch):
    calls = []
    models = []

    def load(repo_or_dir, model, force_reload=False, onnx=False):
        calls.append((repo_or_dir, model, force_reload, onnx))
        models.append(_FakeSilero())
        return models[-1], (_fake_timestamps, None, None, None, None)

    monkeypatch.setattr(torch.hub, "load", load)
    return calls, models


@pytest.mark.parametrize("kind", ["SileroVAD", "SileroVAD8k", "SileroVAD16k"])
def test_silero_detectors_through_a_stub_hub_equal_jax(corpus, stub_hub, kind):
    _, jrecs, precs = corpus
    calls, models = stub_hub
    ours = getattr(PAD, kind)(device="cpu")
    theirs = getattr(JAD, kind)(device="cpu")
    assert calls[0] == calls[1] == ("snakers4/silero-vad", "silero_vad", False, False)
    assert models[0].devices == ["cpu"]
    found = 0
    for orec, jrec in zip(precs, jrecs):
        sups = ours(orec)
        assert _dicts(sups) == _dicts(theirs(jrec))
        found += len(sups)
    assert found > 5
    rate = 8000 if kind == "SileroVAD8k" else 16000
    assert ours._detector_name == theirs._detector_name == f"silero_vad_{rate // 1000}k"
    getattr(PAD, kind).force_download()
    assert calls[-1][2] is True


def test_silero_default_device_is_the_card(stub_hub):
    """The port's Silero detectors load onto the card unless asked; the
    stub model records where it was moved."""
    _, models = stub_hub
    PAD.SileroVAD8k()
    assert PAD.SileroVAD16k().device == "cuda" and models[-1].devices == ["cuda"]
    with pytest.raises(ValueError, match="8000 or 16000"):
        PAD.SileroVAD(device="cpu", sampling_rate=22050)


# -- the CLI --------------------------------------------------------------------------------------


def _read_jsonl_gz(path) -> list:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("output", ["default", "dir", "file"])
def test_cli_energy_vad_output_rule_and_manifest_equal_jax(corpus, tmp_path, output):
    root, _, _ = corpus
    results = {}
    for name, cli in (("port", pcli), ("jax", jcli)):
        work = tmp_path / name
        work.mkdir()
        manifest = work / "recordings.jsonl.gz"
        manifest.write_bytes((root / "recordings.jsonl.gz").read_bytes())
        args = ["workflows", "activity-detection", "-r", str(manifest), "-m", "energy_vad",
                "-t", "0.02", "--min-duration", "0.3"]
        if output == "dir":
            (work / "out").mkdir()
            args += ["-o", str(work / "out")]
        elif output == "file":
            args += ["-o", str(work / "vad.jsonl.gz")]
        res = CliRunner().invoke(cli, args, catch_exceptions=False)
        assert res.exit_code == 0, res.output
        written = res.output.strip().split("Results saved to: ")[-1]
        results[name] = (written.replace(str(work), "<W>"), _read_jsonl_gz(written))
    assert results["port"] == results["jax"]
    expected = {"default": "<W>/recordings_supervisions_energy_vad.jsonl.gz",
                "dir": "<W>/out/recordings_supervisions_energy_vad.jsonl.gz",
                "file": "<W>/vad.jsonl.gz"}[output]
    assert results["port"][0] == expected and len(results["port"][1]) > 5


def test_cli_silero_through_a_stub_hub_equals_jax(corpus, tmp_path, stub_hub):
    root, _, _ = corpus
    outs = {}
    for name, cli in (("port", pcli), ("jax", jcli)):
        out = tmp_path / f"{name}.jsonl.gz"
        res = CliRunner().invoke(cli, [
            "workflows", "activity-detection", "-r", str(root / "recordings.jsonl.gz"), "-o",
            str(out), "-m", "silero_vad_16k", "-d", "cpu", "-j", "2"], catch_exceptions=False)
        assert res.exit_code == 0, res.output
        outs[name] = sorted(_read_jsonl_gz(out), key=lambda d: d["id"])
    assert outs["port"] == outs["jax"] and outs["port"]
