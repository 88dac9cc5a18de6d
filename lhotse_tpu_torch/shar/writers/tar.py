"""
Auto-sharding tar writer (copied from ``lhotse_tpu/shar/writers/tar.py``).
The rolling-shard bookkeeping lives in :class:`_ShardedWriter`, shared with
the JSONL shard writer. Members carry mtime 0, so the same payloads give the
same tar bytes.
"""
import logging
import tarfile
from io import BytesIO
from typing import Callable, List, Optional

from lhotse_tpu_torch.serialization import open_best


class _ShardedWriter:
    """
    Rolling-shard state machine: decides when a new shard starts, names it
    from ``pattern % index``, and fires ``on_shard_complete`` as each shard
    is finalized. Subclasses implement the actual sink
    (:meth:`_open_sink` / :meth:`_close_sink`).
    """

    def __init__(
        self, pattern: str, shard_size: Optional[int] = 1000, shard_offset: int = 0,
        on_shard_complete: Optional[Callable[[str], None]] = None):
        self.pattern, self.shard_size = str(pattern), shard_size
        self.initial_shard_offset, self.on_shard_complete = shard_offset, on_shard_complete
        if self.sharding_enabled:
            if shard_size is None:
                raise RuntimeError(
                    "shard_size must be specified when sharding is enabled via "
                    "a formatting marker such as '%06d'"
                )
        elif shard_size is not None:
            logging.warning(
                "Sharding is disabled because `pattern` doesn't contain a "
                "formatting marker (e.g., '%06d'), but shard_size is not None "
                "- ignoring shard_size."
            )
        self.reset()

    # -- subclass surface -------------------------------------------------

    def _open_sink(self, path: str) -> None:
        raise NotImplementedError

    def _close_sink(self) -> None:
        raise NotImplementedError

    # -- shared machinery --------------------------------------------------

    @property
    def sharding_enabled(self) -> bool:
        return "%" in self.pattern

    def reset(self):
        self.fname = None
        self.num_shards = self.initial_shard_offset
        self.num_items = self.num_items_total = 0

    def __enter__(self):
        self.reset()
        return self

    def __exit__(self, *args, **kwargs):
        self.close()

    def close(self):
        self._close_sink()
        if self.fname is not None and self.on_shard_complete is not None:
            self.on_shard_complete(self.fname)
        self.fname = None

    def _at_shard_boundary(self) -> bool:
        if self.num_items_total == 0:
            return True  # no sink opened yet
        if not self.sharding_enabled or self.num_items == 0:
            return False
        return self.num_items % self.shard_size == 0

    def _advance_shard(self):
        """Finalize the current shard (if any) and open the next sink."""
        self.close()
        if self.sharding_enabled:
            self.fname = self.pattern % self.num_shards
            self.num_shards += 1
        else:
            self.fname = self.pattern
        self._open_sink(self.fname)
        self.num_items = 0

    def _record_item(self):
        self.num_items += 1
        self.num_items_total += 1

    @property
    def output_paths(self) -> List[str]:
        if not self.sharding_enabled:
            return [self.pattern]
        span = range(self.initial_shard_offset, self.num_shards)
        return [self.pattern % i for i in span]


class TarWriter(_ShardedWriter):
    """
    Writes binary blobs into automatically-segmented tar files ("shards") —
    sequential-read-friendly storage for training data.

    Example::

        >>> with TarWriter("some_dir/data.%06d.tar", shard_size=100) as w:
        ...     w.write("blob1", binary_blob1)

    creates ``some_dir/data.000000.tar``, ``data.000001.tar``, ... Use a
    pattern without a formatting marker to disable sharding.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.gzip = self.pattern.endswith(".gz")

    def reset(self):
        super().reset()
        self.stream = None
        self.tarstream = None

    def _open_sink(self, path: str) -> None:
        self.stream = open_best(path, "wb")
        mode = "w|gz" if self.gzip else "w|"
        self.tarstream = tarfile.open(fileobj=self.stream, mode=mode)

    def _close_sink(self) -> None:
        for handle in (getattr(self, "tarstream", None), getattr(self, "stream", None)):
            if handle is not None:
                handle.close()

    def write(self, key: str, data: BytesIO, count: bool = True):
        if count and self._at_shard_boundary():
            self._advance_shard()
        member = tarfile.TarInfo(key)
        data.seek(0)
        member.size = len(data.getvalue())
        self.tarstream.addfile(member, data)
        if count:
            self._record_item()
