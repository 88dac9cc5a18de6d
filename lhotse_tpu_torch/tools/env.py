"""
Tool cache directory and PATH setup for external binaries (e.g. sph2pipe),
copied from ``lhotse_tpu/tools/env.py``. The port keeps its tools apart
from the JAX package's, under ``~/.lhotse_tpu_torch/tools``.
"""
from __future__ import annotations

import logging
import os
import sys
from pathlib import Path


def default_tools_cachedir(force_mkdir: bool = False) -> Path:
    d = Path.home() / ".lhotse_tpu_torch/tools"
    try:
        d.mkdir(exist_ok=True, parents=True)
    except OSError:
        if force_mkdir:
            raise
        logging.warning(
            f"Couldn't create the tool utilities directory: {d} "
            f"(not enough space / no permissions?)"
        )
    return d


def add_tools_to_path():
    sph2pipe_path = str(default_tools_cachedir() / "sph2pipe-2.5")
    sys.path.append(sph2pipe_path)
    os.environ["PATH"] += os.pathsep + sph2pipe_path
