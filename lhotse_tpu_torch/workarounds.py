"""
Workarounds for third-party library quirks (copied from
``lhotse_tpu/workarounds.py``): :class:`Hdf5MemoryIssueFix` closes the
cached HDF5 read handles every ``reset_interval`` batches,
:class:`AltGzipFile` and :func:`gzip_open_robust` read a gzip stream that
ends in trailing garbage, as command-line gzip does.
"""
import gzip
import io
import os


class Hdf5MemoryIssueFix:
    """
    Bounds memory growth when reading HDF5 features: call ``.update()`` per
    batch; every ``reset_interval`` updates all cached HDF5 handles are
    closed (resetting HDF5's internal caches).
    """

    def __init__(self, reset_interval: int = 100) -> None:
        self.reset_interval = reset_interval
        self.counter = 0

    def update(self) -> None:
        self.counter += 1
        if self.counter > self.reset_interval:
            from lhotse_tpu_torch.features.io import close_cached_file_handles

            close_cached_file_handles()
            self.counter = 1


class AltGzipFile(gzip.GzipFile):
    """
    GzipFile variant that, like command-line gzip, tolerates "trailing
    garbage" after the compressed stream instead of raising.
    """

    def read(self, size=-1):
        pieces = []
        want_all = size < 0
        try:
            while want_all or size > 0:
                piece = self.read1() if want_all else self.read1(size)
                if not piece:
                    break
                if not want_all:
                    size -= len(piece)
                pieces.append(piece)
        except OSError as exc:
            # The payload decompressed fine and only the trailing bytes are
            # bogus: swallow the error. Anything else is a real failure.
            garbage_only = pieces and str(exc).startswith("Not a gzipped file")
            if not garbage_only:
                raise
        return b"".join(pieces)


def gzip_open_robust(
    filename, mode="rb", compresslevel=9, encoding=None, errors=None, newline=None):
    """
    ``gzip.open`` equivalent built on :class:`AltGzipFile` (tolerates
    trailing garbage). Accepts a path or an existing binary file object;
    text modes get a TextIOWrapper.
    """
    text = "t" in mode
    if text and "b" in mode:
        raise ValueError(f"Invalid mode: {mode!r}")
    if not text:
        for arg, value in (("encoding", encoding), ("errors", errors), ("newline", newline)):
            if value is not None:
                raise ValueError(f"Argument {arg!r} not supported in binary mode")

    if isinstance(filename, (str, bytes, os.PathLike)):
        stream = AltGzipFile(filename, mode.replace("t", ""), compresslevel)
    elif hasattr(filename, "read") or hasattr(filename, "write"):
        stream = AltGzipFile(None, mode.replace("t", ""), compresslevel, filename)
    else:
        raise TypeError("filename must be a str or bytes object, or a file")

    return io.TextIOWrapper(stream, encoding, errors, newline) if text else stream
