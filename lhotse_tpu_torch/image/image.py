"""
Image manifest: a stored image abstracted from its storage mechanism
(copied from ``lhotse_tpu/image/image.py``): the storage type/path/key
triple plus width/height; the Pillow-based readers and writers are in
:mod:`lhotse_tpu_torch.image.io`. Loading needs Pillow, plotting
matplotlib; both are imported at call time.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Tuple

from lhotse_tpu_torch.utils import Pathlike, fastcopy, is_module_available


@dataclass
class Image:
    """Describes an image stored in a file directory or in memory."""

    storage_type: str
    storage_path: str
    storage_key: str
    width: int
    height: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def is_in_memory(self) -> bool:
        from lhotse_tpu_torch.image.io import is_in_memory

        return is_in_memory(self.storage_type)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "Image":
        if "storage_key" in data and "storage_type" in data and "storage_path" not in data:
            data["storage_path"] = None
        return cls(**data)

    @classmethod
    def from_pillow(cls, data) -> "Image":
        from lhotse_tpu_torch.image.io import PillowInMemoryWriter

        return PillowInMemoryWriter().store_image("", data)

    def load(self, as_pil_image: bool = False):
        """Load the image as a numpy (H, W, C) array or a PIL Image."""
        assert is_module_available("PIL"), "Loading images requires 'pip install pillow'."
        from lhotse_tpu_torch.image.io import get_reader

        storage = get_reader(self.storage_type)(self.storage_path)
        return storage.read(self.storage_key, as_pil_image=as_pil_image)

    def with_path_prefix(self, path: Pathlike) -> "Image":
        return fastcopy(self, storage_path=str(Path(path) / self.storage_path))

    def move_to_memory(self) -> "Image":
        from lhotse_tpu_torch.image.io import get_memory_writer

        if self.storage_type == "pillow_memory":
            return self
        img = self.load()
        writer = get_memory_writer("pillow_memory")()
        data = writer.write("", img)
        return Image(
            storage_type=writer.name, storage_key=data, storage_path="", width=self.width,
            height=self.height)

    def __repr__(self):
        return (
            f"Image(storage_type='{self.storage_type}', "
            f"storage_path='{self.storage_path}', "
            f"storage_key='{self.storage_key if isinstance(self.storage_key, str) else '<binary-data>'}', "
            f"width={self.width}, height={self.height})"
        )

    def plot(self, ax=None, **kwargs):
        """Display the image with matplotlib (optional dependency)."""
        if not is_module_available("matplotlib"):
            raise ImportError("To use Image.plot(), 'pip install matplotlib' first.")
        import matplotlib.pyplot as plt

        img_data = self.load()
        if ax is None:
            _, ax = plt.subplots()
        ax.imshow(img_data, **kwargs)
        ax.axis("off")
        return ax
