"""
Lazy pointers into Shar tar shards (copied from
``lhotse_tpu/shar/lazy_pointer.py``).

A pointer ``<tar_path>?o=<offset>&e=<end_offset>`` names one sample's data
payload inside an indexed tar shard: the byte range comes from the ``.idx``
sidecar and one header read, so :func:`read_payload` is a single ranged read
with no tar parsing. Readers tell the payload's format from its magic bytes.

The reads share the per-process fd cache of the feature archives
(:mod:`lhotse_tpu_torch.features.io`): fds are keyed by (path, pid), so a
forked worker opens its own, and ``os.pread`` keeps no file offset to race
on between loader threads.
"""
from __future__ import annotations

import re
from typing import Any, Tuple

from lhotse_tpu_torch.features.io import _flat_pread, close_cached_file_handles
from lhotse_tpu_torch.utils import Pathlike

_POINTER_RE = re.compile(r"^(?P<tar>[^?]+)\?o=(?P<o>\d+)&e=(?P<e>\d+)$")


def encode_pointer(tar_path: Pathlike, offset: int, end_offset: int) -> str:
    """Encode a Shar lazy-pointer string."""
    return f"{tar_path}?o={int(offset)}&e={int(end_offset)}"


def decode_pointer(s: str) -> Tuple[str, int, int]:
    """Parse a pointer into ``(tar_path, offset, end_offset)``."""
    m = _POINTER_RE.match(s)
    if m is None:
        raise ValueError(f"Not a Shar pointer: {s!r}")
    return m.group("tar"), int(m.group("o")), int(m.group("e"))


def is_shar_pointer(s: Any) -> bool:
    """True iff ``s`` is a string in Shar lazy-pointer form."""
    return isinstance(s, str) and _POINTER_RE.match(s) is not None


def read_payload(pointer: str) -> bytes:
    """Single ranged read of the payload bytes a pointer refers to."""
    tar_path, offset, end_offset = decode_pointer(pointer)
    if end_offset <= offset:
        raise RuntimeError(f"Shar pointer {pointer!r} points at a placeholder (.nodata) member.")
    return _flat_pread(tar_path, offset, end_offset - offset)


def close_all() -> None:
    """Close all cached file descriptors (tests / cleanup)."""
    close_cached_file_handles()
