"""
WebDataset-style tarball export/import (copied from
``lhotse_tpu/dataset/webdataset.py``), needing no ``webdataset`` package:
each sample is one tar member ``<cut_id>.data`` holding the pickled cut dict
with all binary data moved into memory. The tars go through the port's
auto-sharding ``TarWriter`` (members with mtime 0, so both packages write
the same bytes) and are read back with ``tarfile`` streaming: sequential
reads, per-epoch shard shuffling seeded with ``hash((0, epoch))``, and
node/worker shard splitting. Shards may be ``pipe:`` commands.
"""
import logging
import pickle
import random
import tarfile
from io import BytesIO
from typing import Dict, Generator, List, Optional, Sequence, Union

from lhotse_tpu_torch.cut import Cut, CutSet
from lhotse_tpu_torch.lazy import IteratorNode, LazyIteratorChain
from lhotse_tpu_torch.serialization import open_best
from lhotse_tpu_torch.utils import Pathlike, suppress_and_warn


def export_to_webdataset(
    cuts: CutSet, output_path: Pathlike, shard_size: Optional[int] = None, verbose: bool = True,
    audio_format: str = "flac", load_audio: bool = True, load_features: bool = True,
    load_custom: bool = True, fault_tolerant: bool = True) -> int:
    """
    Save CutSet metadata + audio/features data into WebDataset-style
    tarballs: random-access reads become sequential reads at training time.
    With ``shard_size``, ``output_path`` must contain a pattern like
    ``"shard-%06d.tar"``. Returns the number of shards written (0 when
    unsharded).
    """
    writer = WebdatasetWriter(
        path_or_url=output_path, shard_size=shard_size, audio_format=audio_format,
        load_audio=load_audio, load_features=load_features, load_custom=load_custom,
        fault_tolerant=fault_tolerant)

    total = 0
    ok = 0
    with writer:
        for cut in cuts:
            total += 1
            success = writer.write(cut)
            ok += int(success)

    num_shards_written = writer.num_shards_written or 0
    where = (
        f"{num_shards_written} shards" if num_shards_written else "a single tarball"
    )

    logging.info(
        f"Exported {ok} cuts out of {total} total into {where} "
        f"(there were {total - ok} cuts with errors)."
    )

    return num_shards_written


class WebdatasetWriter:
    """
    Writes cuts (with data moved into memory) as pickled tar members.

    Example::

        >>> with WebdatasetWriter("data/tars/shard-%06d.tar", shard_size=500) as w:
        ...     for cut in cuts:
        ...         w.write(cut)
        >>> output_paths = w.output_manifest_paths()
    """

    def __init__(
        self, path_or_url: Pathlike, shard_size: Optional[int] = None, audio_format: str = "flac",
        load_audio: bool = True, load_features: bool = True, load_custom: bool = True,
        fault_tolerant: bool = True) -> None:
        from lhotse_tpu_torch.shar.writers.tar import TarWriter

        self.path_or_url = str(path_or_url)
        self.shard_size = shard_size
        self.audio_format = audio_format
        self.load_audio = load_audio
        self.load_features = load_features
        self.load_custom = load_custom
        self.fault_tolerant = fault_tolerant

        if self.shard_size is not None:
            assert self.shard_size > 0
            assert "%" in self.path_or_url, (
                "With shard_size set, output_path must contain a formatting "
                "pattern, e.g. 'shard-%06d.tar'."
            )
        self.writer = TarWriter(self.path_or_url, shard_size=self.shard_size)
        self.num_shards_written = None
        self.finished = None

    def __enter__(self) -> "WebdatasetWriter":
        self.writer.__enter__()
        self.finished = False
        return self

    def __exit__(self, *args, **kwargs) -> None:
        self.close()

    def close(self) -> None:
        if self.writer.sharding_enabled:
            self.num_shards_written = self.writer.num_shards
        self.writer.close()
        self.finished = True

    def write(self, manifest: Cut) -> bool:
        """Move the cut's data into memory, pickle, and append to the tar."""
        with suppress_and_warn(Exception, enabled=self.fault_tolerant):
            cut = manifest.move_to_memory(
                audio_format=self.audio_format, load_audio=self.load_audio,
                load_features=self.load_features, load_custom=self.load_custom)
            data = pickle.dumps(cut.to_dict())
            self.writer.write(f"{cut.id}.data", BytesIO(data))
            return True
        return False

    def output_manifest_paths(self) -> List[str]:
        """Paths/urls where the data was written (for from_webdataset)."""
        if self.finished is None:
            raise ValueError("The writer has not written anything yet.")
        if not self.finished:
            raise ValueError(
                "The writer was not closed -- call writer.close() first, or "
                "use it as a context manager."
            )
        if self.num_shards_written is None:
            return [self.path_or_url]
        return [self.path_or_url % i for i in range(self.num_shards_written)]


class LazyWebdatasetIterator(IteratorNode):
    """
    Streams Lhotse-style objects from WebDataset tarballs without reading
    them into memory. Sequential-only (no random access); supports shard
    shuffling (epoch-stateful) and node/worker shard splitting.
    """

    def __init__(self, source: Union[Pathlike, Sequence[Pathlike]], **wds_kwargs) -> None:
        self.source = source
        self.wds_kwargs = wds_kwargs

    def set_epoch(self, epoch: int) -> None:
        self.wds_kwargs["epoch"] = epoch

    def _reset(self) -> None:
        self._ds_iter = mini_webdataset(self.source, **self.wds_kwargs)

    def __getstate__(self) -> dict:
        # Pickle only the config; the stream re-initializes in the worker.
        return {"source": self.source, "wds_kwargs": self.wds_kwargs}

    def __setstate__(self, state: Dict) -> None:
        self.__dict__.update(state)

    def __iter__(self) -> "LazyWebdatasetIterator":
        self._reset()
        return self

    def __next__(self):
        from lhotse_tpu_torch.serialization import deserialize_item

        data_dict = next(self._ds_iter)
        data = pickle.loads(data_dict["data"])
        item = deserialize_item(data)
        item.shard_origin = data_dict["__url__"]
        return item

    def values(self):
        yield from self

    def keys(self):
        return (item.id for item in self)

    def items(self):
        return ((item.id, item) for item in self)

    def __add__(self, other) -> LazyIteratorChain:
        return LazyIteratorChain(self, other)


def mini_webdataset(
    urls: Union[Pathlike, Sequence[Pathlike]], epoch: int = 0, shuffle_shards: bool = False,
    split_by_worker: bool = True, split_by_node: bool = False, ignore_error_shards: bool = True,
) -> Generator[Dict, None, None]:
    """
    Stream samples (``{"__key__", "data", "__url__"}`` dicts) from a set of
    WebDataset-style tar shards: optional deterministic per-epoch shard
    shuffle, node/worker shard splitting, per-shard error tolerance.
    """
    from lhotse_tpu_torch.shar.readers.utils import split_by_node as _split_by_node
    from lhotse_tpu_torch.shar.readers.utils import split_by_worker as _split_by_worker

    if isinstance(urls, (str,)) or not isinstance(urls, Sequence):
        urls = [urls]
    urls = [str(u) for u in urls]

    if split_by_node:
        urls = _split_by_node(urls)
    if split_by_worker:
        urls = _split_by_worker(urls)
    if shuffle_shards:
        rng = random.Random(hash((0, epoch)))
        urls = list(urls)
        rng.shuffle(urls)

    for url in urls:
        try:
            with tarfile.open(fileobj=open_best(url, "rb"), mode="r|*") as tar:
                for member in tar:
                    if not member.isfile():
                        continue
                    name = member.name
                    key, _, _ext = name.rpartition(".")
                    payload = tar.extractfile(member).read()
                    yield {"__key__": key or name, "data": payload, "__url__": url}
        except Exception as e:
            if ignore_error_shards:
                logging.warning(f"Skipping shard that failed to load: {url} ({e})")
            else:
                raise


class ShardWriter:
    """
    Webdataset-convention tar shard writer: samples are dicts with a
    ``"__key__"`` entry plus ``extension -> bytes`` payload entries; each
    payload becomes a tar member named ``<key>.<extension>``, and output
    rolls over to a new shard file after ``maxcount`` samples or ``maxsize``
    bytes.

    Implemented over ``tarfile`` + ``open_best`` (upstream lhotse adapts
    ``webdataset.writer.ShardWriter``), so ``pipe:`` patterns work without
    the webdataset package.
    """

    def __init__(
        self,
        pattern: str,
        maxcount: int = 100000,
        maxsize: float = 3e9,
        post=None,
        start_shard: int = 0,
        **kw,
    ):
        assert pattern != "-", "Dash '-' is not an allowed pattern for ShardWriter."
        self.pattern = pattern
        self.maxcount = maxcount
        self.maxsize = maxsize
        self.post = post
        self.shard = start_shard
        self.total = 0
        self.count = 0
        self.size = 0
        self.fname = None
        self.tarstream = None
        self._fileobj = None
        self.next_stream()

    def next_stream(self) -> None:
        """Close the current shard and open the next one."""
        self.finish()
        self.fname = self.pattern % self.shard
        self.shard += 1
        self._fileobj = open_best(self.fname, "wb")
        self.tarstream = tarfile.open(fileobj=self._fileobj, mode="w|")
        self.count = 0
        self.size = 0

    def write(self, obj: Dict) -> None:
        """Write one sample dict (``__key__`` + ``ext -> bytes`` entries)."""
        if (
            self.tarstream is None
            or self.count >= self.maxcount
            or self.size >= self.maxsize
        ):
            self.next_stream()
        key = obj["__key__"]
        written = 0
        for ext, data in obj.items():
            if ext.startswith("__"):
                continue
            if isinstance(data, str):
                data = data.encode("utf-8")
            info = tarfile.TarInfo(name=f"{key}.{ext}")
            info.size = len(data)
            self.tarstream.addfile(info, BytesIO(data))
            written += len(data)
        self.count += 1
        self.total += 1
        self.size += written

    def finish(self) -> None:
        """Flush and close the current shard (``close`` is the public API)."""
        if self.tarstream is not None:
            self.tarstream.close()
            self._fileobj.close()
            if callable(self.post):
                self.post(self.fname)
            self.tarstream = None
            self._fileobj = None

    def close(self) -> None:
        self.finish()

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *args) -> None:
        self.close()


def create_shard_shuffler(epoch: int):
    """
    Return a callable that deterministically shuffles a shard sequence as a
    function of ``(seed=0, epoch)`` — each call advances the epoch, as
    upstream lhotse's ``detshuffle_all`` pipeline stage does (there a
    webdataset ``PipelineStage``, here a plain callable).
    """
    state = {"epoch": epoch - 1}

    def shuffle_all(src):
        state["epoch"] += 1
        rng = random.Random()
        rng.seed(hash((0, state["epoch"])))
        items = list(src)
        rng.shuffle(items)
        return items

    return shuffle_all
