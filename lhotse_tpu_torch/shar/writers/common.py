"""
Shared plumbing for the tar-backed Shar writers (copied from
``lhotse_tpu/shar/writers/common.py``): context management, placeholder
members, and the JSON manifest member that follows each data member.
"""
import json
from io import BytesIO
from typing import Callable, List, Optional

from lhotse_tpu_torch.shar.utils import to_shar_placeholder
from lhotse_tpu_torch.shar.writers.tar import TarWriter


class TarBackedWriter:
    """Owns a :class:`TarWriter` and the shar member-layout conventions:
    one data member per key, followed by an uncounted ``<key>.json`` manifest
    (or ``.nodata``/``.nometa`` placeholder pairs)."""

    def __init__(
        self, pattern: str, shard_size: Optional[int] = 1000, shard_offset: int = 0,
        on_shard_complete: Optional[Callable[[str], None]] = None):
        self.tar_writer = TarWriter(
            pattern, shard_size, shard_offset=shard_offset, on_shard_complete=on_shard_complete)

    def __enter__(self):
        self.tar_writer.__enter__()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()

    def close(self):
        self.tar_writer.close()

    @property
    def output_paths(self) -> List[str]:
        return self.tar_writer.output_paths

    def write_placeholder(self, key: str) -> None:
        self.tar_writer.write(f"{key}.nodata", BytesIO())
        self.tar_writer.write(f"{key}.nometa", BytesIO(), count=False)

    def _write_manifest(self, key: str, manifest) -> None:
        """Serialize the shar-placeholder manifest as the JSON member that
        immediately follows the data member."""
        payload = json.dumps(to_shar_placeholder(manifest).to_dict()) + "\n"
        self.tar_writer.write(f"{key}.json", BytesIO(payload.encode("utf-8")), count=False)
