"""
Lazy compilation and caching of the package's native (C) components
(copied from ``lhotse_tpu/native_build.py``): each shared library is built
once with the system C compiler from ``native/<name>/<src>`` into
``build/lhotse_tpu_torch/native/<name>-<hash>/`` beside the package, where
``<hash>`` covers the source and the flags, and loaded with ``ctypes``.
A failed build raises: there is no pure-Python fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
NATIVE_ROOT = Path(__file__).resolve().parent / "native"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "lhotse_tpu_torch" / "native"


def native_disabled() -> bool:
    """True when ``LHOTSE_TPU_NO_NATIVE=1``: the JAX package's switch to its
    pure-Python fallbacks. The port has no such fallbacks, so nothing in it
    reads the switch; it is kept so that code written for either package
    can ask."""
    return os.environ.get("LHOTSE_TPU_NO_NATIVE") == "1"


def build_native(name: str, source: str, extra_link: Optional[List[str]] = None) -> ctypes.CDLL:
    """
    Build (if needed) and load ``native/<name>/<source>`` as ``lib<name>.so``.
    Raises on failure.
    """
    key = f"{name}:{source}"
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        src = NATIVE_ROOT / name / source
        if not src.is_file():
            raise FileNotFoundError(f"Native source not found: {src}")
        cc = os.environ.get("CC", "cc")
        # The .so is never shipped (built per checkout and host), so
        # -march=native is safe and lets the SIMD loops vectorize to
        # whatever the local CPU has; retry without it for compilers that
        # reject the flag.
        flag_sets = [
            ["-O3", "-march=native", "-fno-math-errno"],
            ["-O3"],
        ]
        digest = hashlib.sha256(
            src.read_bytes() + repr((cc, flag_sets, extra_link)).encode()).hexdigest()[:16]
        so = BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"
        if not so.is_file():
            so.parent.mkdir(parents=True, exist_ok=True)
            # Per-PID temp name and an atomic rename: spawned workers
            # compiling at once never load a half-written library.
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            last_err = None
            for flags in flag_sets:
                cmd = [cc, *flags, "-shared", "-fPIC", "-o", str(tmp), str(src)]
                cmd += extra_link or []
                try:
                    subprocess.run(cmd, check=True, capture_output=True)
                    os.replace(tmp, so)
                    break
                except (subprocess.CalledProcessError, OSError) as e:
                    last_err = e
                    tmp.unlink(missing_ok=True)
            if not so.is_file():
                raise RuntimeError(f"Failed to build native component '{name}': {last_err}")
        lib = ctypes.CDLL(str(so))
        _LIBS[key] = lib
        return lib
