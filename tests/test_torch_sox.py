"""
The port's sox resampler (``lhotse_tpu_torch/tools/libsox.py``) and the
``"sox"`` resampling backend (``audio/resampling_backend.py`` and the
``Resample`` transform) against the JAX package's. Neither machine has
``sox``, so the tests put one stub ``sox`` script on ``PATH`` for both
packages: it logs its argv and maps the f32 stream deterministically
(nearest earlier input frame at the output rate, times 0.5). The argv and
the output must equal JAX's exactly, and ``"sox"`` is listed only while the
binary is found.
"""
import importlib
import json
import os
import sys

import numpy as np
import pytest

import lhotse_tpu as J
from lhotse_tpu.audio.backend import save_audio as jsave_audio
from lhotse_tpu.augmentation.transforms import Resample as JResample
from lhotse_tpu.tools import libsox as jsox
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.augmentation.transforms import Resample
from lhotse_tpu_torch.tools import libsox as psox

# The audio packages export a function of the module's name.
jrb = importlib.import_module("lhotse_tpu.audio.resampling_backend")
prb = importlib.import_module("lhotse_tpu_torch.audio.resampling_backend")

STUB = """#!{python}
import json, sys
import numpy as np

args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
rate_in, channels, rate_out = int(args[3]), int(args[5]), int(args[-1])
x = np.frombuffer(sys.stdin.buffer.read(), dtype=np.float32).reshape(-1, channels)
m = x.shape[0] * rate_out // rate_in
idx = (np.arange(m) * rate_in) // rate_out
sys.stdout.buffer.write((x[idx] * np.float32(0.5)).astype(np.float32).tobytes())
"""


@pytest.fixture
def sox(tmp_path, monkeypatch):
    """A stub ``sox`` first on PATH; returns the log of its argv lines."""
    bindir, log = tmp_path / "bin", tmp_path / "sox.log"
    bindir.mkdir()
    stub = bindir / "sox"
    stub.write_text(STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ.get('PATH', '')}")
    monkeypatch.setattr(prb, "CURRENT_RESAMPLING_BACKEND", None)
    monkeypatch.setattr(jrb, "CURRENT_RESAMPLING_BACKEND", None)
    monkeypatch.delenv("LHOTSE_TPU_RESAMPLING_BACKEND", raising=False)
    monkeypatch.delenv("LHOTSE_RESAMPLING_BACKEND", raising=False)

    def argv():
        return [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []

    return argv


def test_sox_is_listed_only_where_the_binary_is_found(sox, monkeypatch):
    assert psox.libsox_available() and jsox.libsox_available()
    assert prb.available_resampling_backends() == jrb.available_resampling_backends() == [
        "default", "sox"]
    monkeypatch.setenv("PATH", "")
    assert not psox.libsox_available()
    assert prb.available_resampling_backends() == jrb.available_resampling_backends() == [
        "default"]
    with pytest.raises(ValueError, match="Invalid resampling backend"):
        prb.set_current_resampling_backend("sox")
    with pytest.raises(RuntimeError, match="sox is not installed"):
        psox.libsox_rate(np.zeros(16, np.float32), 16000, 8000)


@pytest.mark.parametrize("shape,rates,quality", [
    ((1600,), (16000, 8000), "v"), ((2, 4410), (44100, 16000), "h"), ((3, 800), (8000, 22050), "q")])
def test_libsox_rate_argv_and_output_equal_jax(sox, shape, rates, quality):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    ours = psox.libsox_rate(x, *rates, quality=quality)
    theirs = jsox.libsox_rate(x, *rates, quality=quality)
    log = sox()
    assert len(log) == 2 and log[0] == log[1]
    assert log[0][-3:] == ["rate", f"-{quality}", str(rates[1])]
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)
    rows = x if x.ndim == 2 else x[None]
    idx = (np.arange(rows.shape[1] * rates[1] // rates[0]) * rates[0]) // rates[1]
    assert np.array_equal(ours if x.ndim == 2 else ours[None], rows[:, idx] * np.float32(0.5))


def test_resample_transform_and_recording_through_the_sox_backend_equal_jax(sox, tmp_path):
    x = np.random.default_rng(5).standard_normal((2, 16000)).astype(np.float32) * 0.1
    prb.set_current_resampling_backend("sox")
    jrb.set_current_resampling_backend("sox")
    assert prb.get_current_resampling_backend() == jrb.get_current_resampling_backend() == "sox"
    assert np.array_equal(Resample(16000, 8000)(x), JResample(16000, 8000)(x))
    jsave_audio(tmp_path / "a.flac", x, 16000)
    ours = Recording.from_file(tmp_path / "a.flac").resample(8000)
    theirs = J.Recording.from_file(tmp_path / "a.flac").resample(8000)
    assert ours.to_dict() == theirs.to_dict()
    assert np.array_equal(ours.load_audio(), theirs.load_audio())
    log = sox()
    assert len(log) == 4 and log[0] == log[1] and log[2] == log[3]
    # The default backend does not call sox.
    with prb.resampling_backend("default"):
        Resample(16000, 8000)(x)
    assert len(sox()) == 4


def test_the_sox_backend_from_the_environment(sox, monkeypatch):
    monkeypatch.setenv("LHOTSE_TPU_RESAMPLING_BACKEND", "sox")
    x = np.random.default_rng(6).standard_normal(1600).astype(np.float32)
    assert np.array_equal(Resample(16000, 8000)(x), JResample(16000, 8000)(x))
    assert len(sox()) == 2
