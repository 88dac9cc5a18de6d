from lhotse_tpu_torch.shar.writers.array import ArrayTarWriter
from lhotse_tpu_torch.shar.writers.audio import AudioTarWriter
from lhotse_tpu_torch.shar.writers.cut import JsonlShardWriter
from lhotse_tpu_torch.shar.writers.shar import SharWriter
from lhotse_tpu_torch.shar.writers.tar import TarWriter

__all__ = ["ArrayTarWriter", "AudioTarWriter", "JsonlShardWriter", "SharWriter", "TarWriter"]
