"""
SharWriter: export cuts and their data into the Shar format (copied from
``lhotse_tpu/shar/writers/shar.py``). Each shard is one JSONL cut
manifest plus one tar per data field; with ``compress_jsonl=False`` and
``create_index=True`` every file gets its ``.idx`` sidecar, for constant
time access and exact checkpoint restore. Indexing a finished shard is
best effort: a shard that cannot be indexed is left without a sidecar.
"""
import warnings
from functools import partial
from typing import Dict, Literal, Optional, Tuple, Type, Union

from lhotse_tpu_torch.array import Array, TemporalArray
from lhotse_tpu_torch.audio import Recording
from lhotse_tpu_torch.cut import Cut
from lhotse_tpu_torch.shar.utils import to_shar_placeholder
from lhotse_tpu_torch.shar.writers.array import ArrayTarWriter
from lhotse_tpu_torch.shar.writers.audio import AudioTarWriter
from lhotse_tpu_torch.shar.writers.cut import JsonlShardWriter
from lhotse_tpu_torch.utils import Pathlike, fastcopy, ifnone

FieldWriterInstance = Union[AudioTarWriter, ArrayTarWriter]
FieldWriter = Type[FieldWriterInstance]


class SharWriter:
    """
    Writes cuts and their data into numbered shards: one jsonl manifest +
    one tar per data field per shard.

    Example::

        >>> with SharWriter("some_dir", shard_size=100,
        ...                 fields={"recording": "wav", "features": "lilcom"}) as w:
        ...     for cut in cuts:
        ...         w.write(cut)

    creates ``some_dir/cuts.000000.jsonl.gz``, ``some_dir/recording.000000.tar``,
    ``some_dir/features.000000.tar``, etc. Use ``compress_jsonl=False`` for
    indexable cut shards; ``shard_size=None`` disables sharding;
    ``include_cuts=False`` writes only the field archives (useful when
    extending an existing dataset with new fields).
    """

    def __init__(
        self, output_dir: Pathlike, fields: Dict[str, str], shard_size: Optional[int] = 1000,
        warn_unused_fields: bool = True, include_cuts: bool = True,
        shard_suffix: Optional[str] = None, shard_offset: int = 0, compress_jsonl: bool = True,
        create_index: bool = True) -> None:
        self.output_dir = str(output_dir)
        if not _is_non_local_output(self.output_dir):
            from pathlib import Path

            Path(self.output_dir).mkdir(parents=True, exist_ok=True)
        self.shard_size = shard_size
        self.fields = fields
        self.warn_unused_fields = warn_unused_fields
        self.include_cuts = include_cuts
        self.compress_jsonl = compress_jsonl
        self.create_index = create_index
        if self.create_index and _is_non_local_output(self.output_dir):
            raise ValueError(
                "create_index=True is only supported for local output paths. "
                f"Got output_dir='{self.output_dir}'. "
                "Set create_index=False for pipe/URL/cloud outputs."
            )
        if self.create_index and self.compress_jsonl:
            warnings.warn(
                "create_index=True with compress_jsonl=True creates only a " "partially indexed Shar: compressed cuts.*.jsonl.gz shards " "cannot be indexed. Use compress_jsonl=False to enable exact " "indexed Shar restore.",
                stacklevel=2)
        if self.sharding_enabled:
            assert shard_suffix is None, (
                f"shard_suffix must be None when shard_size is specified "
                f"(got: '{shard_suffix}')."
            )
            self.shard_suffix = ".%06d"
        else:
            self.shard_suffix = ifnone(shard_suffix, "")
        self.initial_shard_offset = shard_offset

        self.writers = self._build_writers(include_cuts)

    def _build_writers(self, include_cuts: bool) -> dict:
        callback = self._index_shard if self.create_index else None
        common = dict(
            shard_size=self.shard_size, shard_offset=self.initial_shard_offset,
            on_shard_complete=callback)
        writers = {}
        if include_cuts:
            cuts_url = _create_cuts_output_url(
                self.output_dir, self.shard_suffix, compress=self.compress_jsonl)
            writers["cuts"] = JsonlShardWriter(pattern=cuts_url, **common)
        for field, writer_type in self.fields.items():
            make_writer_fn, ext = resolve_writer(writer_type, compress_jsonl=self.compress_jsonl)
            pattern = f"{self.output_dir}/{field}{self.shard_suffix}{ext}"
            writers[field] = make_writer_fn(pattern=pattern, **common)
        return writers

    sharding_enabled = property(lambda self: self.shard_size is not None and self.shard_size > 0)
    output_paths = property(
        lambda self: {field: w.output_paths for field, w in self.writers.items()}
    )

    def __enter__(self):
        for w in self.writers.values():
            w.__enter__()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()

    def close(self):
        for w in self.writers.values():
            w.close()

    def _index_shard(self, path_str: str) -> None:
        """Index a completed shard (per-shard on_shard_complete callback)."""
        from lhotse_tpu_torch.indexing import create_jsonl_index, create_tar_index

        path_str = str(path_str)
        if path_str.startswith("pipe:"):
            return  # pipes are not seekable
        if path_str.startswith(("http://", "https://", "s3://", "gs://")):
            raise ValueError(
                "create_index=True is only supported for local output paths. "
                f"Got remote shard path '{path_str}'. "
                "Set create_index=False for pipe/URL/cloud outputs."
            )
        indexer = None
        if path_str.endswith(".jsonl"):
            indexer = create_jsonl_index
        elif path_str.endswith(".tar"):
            indexer = create_tar_index
        if indexer is not None:
            try:
                indexer(path_str)
            except (RuntimeError, OSError):
                pass  # indexing is best-effort; readers fall back gracefully

    def _warn_unused(self, key: str) -> None:
        if self.warn_unused_fields:
            warnings.warn(f"Found cut with '{key}' field that is not specified for Shar writing.")

    def _store_recording(self, cut: Cut) -> Cut:
        if not cut.has_recording:
            self.writers["recording"].write_placeholder(cut.id)
            return cut
        data = cut.load_audio()
        placeholder = to_shar_placeholder(cut.recording, cut)
        span_channels = _aslist(cut.channel)
        if placeholder.channel_ids != span_channels:
            # The cut may reference a channel subset of the recording.
            placeholder.sources[0].channels = span_channels
            placeholder.channel_ids = span_channels
        self.writers["recording"].write(
            cut.id, data, cut.sampling_rate, manifest=placeholder,
            original_format=cut.recording.source_format)
        return fastcopy(cut, recording=placeholder)

    def _store_features(self, cut: Cut) -> Cut:
        if not cut.has_features:
            self.writers["features"].write_placeholder(cut.id)
            return cut
        placeholder = to_shar_placeholder(cut.features, cut)
        self.writers["features"].write(cut.id, cut.load_features(), manifest=placeholder)
        return fastcopy(cut, features=placeholder)

    def _store_custom(self, cut: Cut, key: str) -> Cut:
        if not cut.has_custom(key):
            self.writers[key].write_placeholder(cut.id)
            return cut
        val = getattr(cut, key)
        if not isinstance(val, (Array, TemporalArray, Recording)):
            assert isinstance(self.writers[key], JsonlShardWriter), (
                f"Expected writer type 'jsonl' (got '{self.fields[key]}') "
                f"for non-data field '{key}'."
            )
            self.writers[key].write({"cut_id": cut.id, key: val})
            return cut
        data = cut.load_custom(key)
        placeholder = to_shar_placeholder(val, cut)
        selector_key = f"{key}_channel_selector"
        kwargs = {}
        if isinstance(val, Recording):
            kwargs["sampling_rate"] = val.sampling_rate
            if cut.has_custom(selector_key):
                # The audio was loaded through the cut's channel selector —
                # reflect that in the stored manifest.
                placeholder.sources[0].channels = cut.custom[selector_key]
                placeholder.channel_ids = cut.custom[selector_key]
        self.writers[key].write(cut.id, data, manifest=placeholder, **kwargs)
        cut = fastcopy(cut, custom=dict(cut.custom))
        cut.custom.pop(selector_key, None)
        setattr(cut, key, placeholder)
        return cut

    def write(self, cut: Cut) -> None:
        if "recording" in self.fields:
            cut = self._store_recording(cut)
        elif cut.has_recording:
            self._warn_unused("recording")

        if "features" in self.fields:
            cut = self._store_features(cut)
        elif cut.has_features:
            self._warn_unused("features")

        for key in self.fields:
            if key not in ("recording", "features"):
                cut = self._store_custom(cut, key)

        # Warn about attached data not requested for saving.
        for key, val in ifnone(cut.custom, {}).items():
            if isinstance(val, (Array, TemporalArray, Recording)) and key not in self.fields:
                self._warn_unused(key)

        # Data was stored for exactly the cut span: reset the offset.
        cut = fastcopy(cut, start=0)
        if "cuts" in self.writers:
            self.writers["cuts"].write(cut)


_AUDIO_FORMATS = ("wav", "flac", "mp3", "opus", "original")
_ARRAY_COMPRESSIONS = ("lilcom", "numpy")
# The writer-name vocabulary accepted in ``fields=``.
WriterName = Literal[
    "wav", "flac", "mp3", "opus", "original", "lilcom", "numpy", "jsonl"]


def resolve_writer(name: str, compress_jsonl: bool = True) -> Tuple[FieldWriter, str]:
    if name in _AUDIO_FORMATS:
        return partial(AudioTarWriter, format=name), ".tar"
    if name in _ARRAY_COMPRESSIONS:
        return partial(ArrayTarWriter, compression=name), ".tar"
    if name == "jsonl":
        return JsonlShardWriter, ".jsonl.gz" if compress_jsonl else ".jsonl"
    supported = ", ".join((*_AUDIO_FORMATS, *_ARRAY_COMPRESSIONS, "jsonl"))
    raise AssertionError(f"Unknown field type (got: '{name}', we support only: {supported}")


def _create_cuts_output_url(base_output_url: str, shard_suffix: str, compress: bool = True) -> str:
    ext = ".jsonl.gz" if compress else ".jsonl"
    if base_output_url.startswith("pipe:") and compress:
        base_output_url = base_output_url.replace("pipe:", "pipe:gzip -c | ")
    return f"{base_output_url}/cuts{shard_suffix}{ext}"


def _is_non_local_output(path: str) -> bool:
    return path.startswith("pipe:") or "://" in path


def _aslist(x):
    if isinstance(x, list):
        return x
    return [x]
