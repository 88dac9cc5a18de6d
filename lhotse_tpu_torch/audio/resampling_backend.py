"""
The resampling backend switch (port of
``lhotse_tpu/audio/resampling_backend.py``): a process-global choice, set
with :func:`set_current_resampling_backend`, for a ``with`` block with
:func:`resampling_backend`, or through the ``LHOTSE_TPU_RESAMPLING_BACKEND``
environment variable (``LHOTSE_RESAMPLING_BACKEND`` as a fallback). The
``Resample`` audio transform consults it.

The backends are ``"default"``, the built-in polyphase sinc resampler, and
``"sox"`` (:mod:`lhotse_tpu_torch.tools.libsox`), listed only where a
``sox`` binary is found on ``PATH``; a name not listed raises
``ValueError`` as in the JAX package. Two departures, both so that the environment variable and the
switch cannot disagree: the variable is read on every call until a backend
is set explicitly (the JAX package caches its first reading), and the
context manager restores the explicit choice it found, or none.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional

from lhotse_tpu_torch.tools.libsox import libsox_available

ResamplingBackend = str  # "default" | "sox"

CURRENT_RESAMPLING_BACKEND: Optional[ResamplingBackend] = None


def available_resampling_backends() -> List[ResamplingBackend]:
    backends = ["default"]
    if libsox_available():
        backends.append("sox")
    return backends


def _check(backend: ResamplingBackend) -> ResamplingBackend:
    if backend not in available_resampling_backends():
        raise ValueError(
            f"Invalid resampling backend: {backend}. "
            f"Available backends: {available_resampling_backends()}"
        )
    return backend


def set_current_resampling_backend(backend: ResamplingBackend) -> None:
    global CURRENT_RESAMPLING_BACKEND
    CURRENT_RESAMPLING_BACKEND = _check(backend)


def get_current_resampling_backend() -> ResamplingBackend:
    if CURRENT_RESAMPLING_BACKEND is not None:
        return CURRENT_RESAMPLING_BACKEND
    from_env = os.environ.get("LHOTSE_TPU_RESAMPLING_BACKEND") or os.environ.get(
        "LHOTSE_RESAMPLING_BACKEND")
    return _check(from_env) if from_env else "default"


@contextlib.contextmanager
def resampling_backend(backend: ResamplingBackend):
    """Temporarily switch the resampling backend within a ``with`` block."""
    global CURRENT_RESAMPLING_BACKEND
    previous = CURRENT_RESAMPLING_BACKEND
    set_current_resampling_backend(backend)
    try:
        yield
    finally:
        CURRENT_RESAMPLING_BACKEND = previous
