from lhotse_tpu_torch.shar.readers.indexed import LazyIndexedSharIterator
from lhotse_tpu_torch.shar.readers.lazy import LazySharIterator
from lhotse_tpu_torch.shar.readers.tar import TarIterator, parse_tar_sample

__all__ = ["LazyIndexedSharIterator", "LazySharIterator", "TarIterator", "parse_tar_sample"]
