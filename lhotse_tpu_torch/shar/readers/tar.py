"""
Streaming and indexed tar parsing for Shar shards (copied from
``lhotse_tpu/shar/readers/tar.py``): :class:`TarIterator` walks a shard's
(data, metadata) member pairs front to back; ``parse_tar_sample`` decodes
one pair read by :class:`lhotse_tpu_torch.indexing.IndexedTarReader`.
"""
import tarfile
from pathlib import Path
from typing import Generator, Optional, Tuple, Union

from lhotse_tpu_torch.array import Array, TemporalArray
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.features import Features
from lhotse_tpu_torch.serialization import decode_json_line, deserialize_item, open_best
from lhotse_tpu_torch.shar.utils import fill_shar_placeholder
from lhotse_tpu_torch.utils import Pathlike

Manifest = Union[Recording, Array, TemporalArray, Features]


class TarIterator:
    """
    Sequential reader over a Shar tar shard. Expects pairs of members:
    data first (named ``<key>.<ext>``; ``<key>.nodata`` when absent), then
    metadata (``<key>.json`` holding a manifest; ``<key>.nometa`` when
    absent). Yields ``(manifest_with_data_or_None, data_path)``.
    """

    def __init__(self, source: Pathlike) -> None:
        self.source = source

    def __iter__(self) -> Generator[Tuple[Optional[Manifest], Path], None, None]:
        with tarfile.open(fileobj=open_best(self.source, mode="rb"), mode="r|*") as tar:
            for (data, data_path), (meta, meta_path) in iterate_tarfile_pairwise(tar):
                if meta is not None:
                    meta = deserialize_item(decode_json_line(meta.decode("utf-8")))
                    fill_shar_placeholder(manifest=meta, data=data, tarpath=data_path)
                yield meta, data_path


def iterate_tarfile_pairwise(
    tar_file: tarfile.TarFile,
) -> Generator[Tuple[Tuple[Optional[bytes], Path], Tuple[Optional[bytes], Path]], None, None]:
    result = []
    for tarinfo in tar_file:
        if len(result) == 2:
            yield tuple(result)
            result = []
        result.append(parse_tarinfo(tarinfo, tar_file))

    if len(result) == 2:
        yield tuple(result)

    if len(result) == 1:
        raise RuntimeError(
            "Uneven number of files in the tarfile (expected to iterate pairs "
            "of binary data + JSON metadata)."
        )


def parse_tarinfo(
    tarinfo: tarfile.TarInfo, tar_file: tarfile.TarFile) -> Tuple[Optional[bytes], Path]:
    """Read a member's bytes (None for .nodata/.nometa placeholders)."""
    path = Path(tarinfo.path)
    if path.suffix == ".nodata" or path.suffix == ".nometa":
        return None, path
    data = tar_file.extractfile(tarinfo).read()
    return data, path


def parse_tar_sample(
    data: Optional[bytes], data_name: str, meta_bytes: Optional[bytes], meta_name: str,
) -> Tuple[Optional[Manifest], Path]:
    """
    Decode one (data member, metadata member) pair that was read directly by
    an indexed reader: returns ``(manifest_with_data_or_None, data_path)``.
    """
    data_path = Path(data_name)
    if data_path.suffix == ".nodata" or Path(meta_name).suffix == ".nometa":
        return None, data_path
    manifest = deserialize_item(decode_json_line(meta_bytes.decode("utf-8")))
    fill_shar_placeholder(manifest=manifest, data=data, tarpath=data_path)
    return manifest, data_path
