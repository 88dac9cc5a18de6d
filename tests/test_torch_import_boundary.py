"""
The port's import boundary: lhotse_tpu_torch and chip_smoke.py import
neither jax nor lhotse_tpu, and importing the kernel's module needs no CUDA
toolkit. Checked in subprocesses, because this test process has already
imported jax (tests/conftest.py).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "lhotse_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from) (jax|lhotse_tpu)\b", re.MULTILINE)


def _python(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, **env})


def test_port_imports_neither_jax_nor_lhotse_tpu():
    proc = _python(
        "import lhotse_tpu_torch, lhotse_tpu_torch.dataset.device_augment, "
        "lhotse_tpu_torch.ops.fbank_cuda, lhotse_tpu_torch.convert, "
        "lhotse_tpu_torch.dataset.signal_transforms, lhotse_tpu_torch.ops.wire, "
        "lhotse_tpu_torch.dataset.device_cache, lhotse_tpu_torch.dataset.loader, "
        "lhotse_tpu_torch.features.kaldi.extractors; import sys; "
        "assert 'jax' not in sys.modules and 'lhotse_tpu' not in sys.modules, "
        "sorted(m for m in sys.modules if m.startswith(('jax', 'lhotse_tpu.')))")
    assert proc.returncode == 0, proc.stderr


def test_cpu_route_needs_no_nvcc():
    """Without a CUDA toolkit the kernel's module imports and a CPU tensor
    takes the plain version: nothing is built."""
    proc = _python(
        "import torch; from lhotse_tpu_torch import _build; "
        "from lhotse_tpu_torch.ops import fbank_cuda; "
        "from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank; "
        "out = Wav2LogFilterBank()(torch.zeros(2, 16000)); "
        "assert out.shape == (2, 100, 80); "
        "assert _build.load.cache_info().currsize == 0",
        PATH="/nonexistent", CUDA_HOME="/nonexistent", CUDA_PATH="/nonexistent")
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_has_no_jax_import(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path
