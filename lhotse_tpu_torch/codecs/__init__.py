"""The LTC1 feature codec (port of ``lhotse_tpu/codecs``)."""
from lhotse_tpu_torch.codecs.lilcom_codec import compress, decompress, decompress_concat

__all__ = ["compress", "decompress", "decompress_concat"]
