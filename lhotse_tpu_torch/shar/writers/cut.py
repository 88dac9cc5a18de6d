"""
Sharded JSONL writer for cuts and dicts (copied from
``lhotse_tpu/shar/writers/cut.py``), on the rolling-shard base class of
:mod:`lhotse_tpu_torch.shar.writers.tar`.
"""
from typing import Union

from lhotse_tpu_torch.cut import Cut
from lhotse_tpu_torch.serialization import SequentialJsonlWriter
from lhotse_tpu_torch.shar.writers.tar import _ShardedWriter


class JsonlShardWriter(_ShardedWriter):
    """
    Writes Cuts or dicts into multiple JSONL shards (gzip when the pattern
    ends with ``.gz``).

    Example::

        >>> with JsonlShardWriter("some_dir/cuts.%06d.jsonl.gz", shard_size=100) as w:
        ...     for cut in ...:
        ...         w.write(cut)
    """

    def reset(self):
        super().reset()
        self.stream = None

    def _open_sink(self, path: str) -> None:
        self.stream = SequentialJsonlWriter(path)

    def _close_sink(self) -> None:
        if getattr(self, "stream", None) is not None:
            self.stream.close()

    def write(self, data: Union[Cut, dict], flush: bool = False) -> None:
        if self._at_shard_boundary():
            self._advance_shard()
        self.stream.write(data, flush=flush)
        self._record_item()

    def write_placeholder(self, cut_id: str, flush: bool = False) -> None:
        self.write({"cut_id": cut_id}, flush=flush)
