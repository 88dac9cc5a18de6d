from lhotse_tpu_torch.shar.lazy_pointer import (
    decode_pointer, encode_pointer, is_shar_pointer, read_payload)
from lhotse_tpu_torch.shar.readers import (
    LazyIndexedSharIterator, LazySharIterator, TarIterator, parse_tar_sample)
from lhotse_tpu_torch.shar.utils import (
    fill_shar_placeholder, fill_shar_placeholder_lazy, to_shar_placeholder)
from lhotse_tpu_torch.shar.writers import (
    ArrayTarWriter, AudioTarWriter, JsonlShardWriter, SharWriter, TarWriter)

__all__ = [
    "ArrayTarWriter", "AudioTarWriter", "JsonlShardWriter", "LazyIndexedSharIterator",
    "LazySharIterator", "SharWriter", "TarIterator", "TarWriter", "decode_pointer",
    "encode_pointer", "fill_shar_placeholder", "fill_shar_placeholder_lazy", "is_shar_pointer",
    "parse_tar_sample", "read_payload", "to_shar_placeholder"]
