"""
Build the port's CUDA sources with ``nvcc`` at first use and load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/lhotse_tpu_torch/<name>-<hash>/lib<name>.so`` beside the
package, where ``<hash>`` covers the source and the compiler flags: an
edited source builds anew, an unchanged one loads the library it built
before. ``nvcc``'s output, with ``-Xptxas -v``'s register and shared-memory
report, is kept in ``build.log`` next to the library.

Nothing here runs at import time, so the CPU-only tests import every module
without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "lhotse_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("No CUDA toolkit found: nvcc is needed to build the port's CUDA kernels.")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source and flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    return the library's path."""
    lib = library_path(name)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # A private temporary name and an atomic rename: processes that build
    # the same source at once never load a half-written library.
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr + f"\n[build] {time.perf_counter() - t0:.2f} s\n"
    (lib.parent / "build.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per process."""
    return ctypes.CDLL(str(build(name)))
