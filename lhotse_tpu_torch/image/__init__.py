from lhotse_tpu_torch.image.image import Image
from lhotse_tpu_torch.image.io import (
    PillowInMemoryReader, PillowInMemoryWriter, PillowReader, PillowWriter)

__all__ = ["Image", "PillowInMemoryReader", "PillowInMemoryWriter", "PillowReader", "PillowWriter"]
