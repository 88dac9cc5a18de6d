"""
Image storage backends (copied from ``lhotse_tpu/image/io.py``): Pillow
readers and writers over a directory (``pillow_files``) and over PNG bytes
held in the manifest (``pillow_memory``). Pillow is imported at call time.
"""
from __future__ import annotations

from abc import ABCMeta, abstractmethod
from io import BytesIO
from pathlib import Path
from typing import Dict, List, Type

import numpy as np

from lhotse_tpu_torch.utils import Pathlike

READER_BACKENDS: Dict[str, Type["ImageReader"]] = {}
WRITER_BACKENDS: Dict[str, Type["ImageWriter"]] = {}


class ImageReader(metaclass=ABCMeta):
    """Reads images from a storage location keyed by string keys."""

    @property
    @abstractmethod
    def name(self) -> str:
        ...

    @abstractmethod
    def read(self, key: str, as_pil_image: bool = False):
        ...


class ImageWriter(metaclass=ABCMeta):
    """Writes images to a storage location and returns Image manifests."""

    @property
    @abstractmethod
    def name(self) -> str:
        ...

    @property
    @abstractmethod
    def storage_path(self) -> str:
        ...

    @abstractmethod
    def write(self, key: str, value) -> str:
        ...

    def store_image(self, key: str, value):
        """
        Store an image (path / numpy array / PIL image) and return the
        corresponding :class:`~lhotse_tpu_torch.image.image.Image` manifest.
        """
        from PIL import Image as PILImage

        from lhotse_tpu_torch.image.image import Image

        if isinstance(value, (str, Path)):
            pil = PILImage.open(value)
        else:
            # An array, encoded bytes (the JAX package passes bytes on as if
            # they were an image and fails: ROADMAP C2) or a PIL image.
            pil = _as_pil(value)
        storage_key = self.write(key, pil)
        return Image(
            storage_type=self.name,
            storage_path=str(self.storage_path) if self.storage_path is not None else "",
            storage_key=storage_key, width=pil.width, height=pil.height)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *args, **kwargs):
        self.close()


def available_storage_backends() -> List[str]:
    return sorted(READER_BACKENDS)


def register_reader(cls):
    READER_BACKENDS[cls.name] = cls
    return cls


def register_writer(cls):
    WRITER_BACKENDS[cls.name] = cls
    return cls


def get_reader(name: str) -> Type[ImageReader]:
    return READER_BACKENDS[name]


def get_writer(name: str) -> Type[ImageWriter]:
    return WRITER_BACKENDS[name]


def get_memory_writer(name: str) -> Type[ImageWriter]:
    assert "memory" in name
    return WRITER_BACKENDS[name]


def is_in_memory(storage_type: str) -> bool:
    return "memory" in storage_type


@register_reader
class PillowReader(ImageReader):
    """Reads image files from a directory."""

    name = "pillow_files"

    def __init__(self, storage_path: Pathlike, *args, **kwargs):
        self._storage_path = Path(storage_path)

    @property
    def storage_path(self) -> str:
        return str(self._storage_path)

    def read(self, key: str, as_pil_image: bool = False):
        from PIL import Image as PILImage

        img = PILImage.open(self._storage_path / key)
        if as_pil_image:
            return img
        return np.asarray(img)


def _as_pil(value):
    """Accept a PIL image, numpy (H, W[, C]) array, or encoded bytes."""
    from PIL import Image as PILImage

    if isinstance(value, np.ndarray):
        return PILImage.fromarray(value)
    if isinstance(value, bytes):
        return PILImage.open(BytesIO(value))
    return value


@register_writer
class PillowWriter(ImageWriter):
    """Writes image files into a directory."""

    name = "pillow_files"

    def __init__(self, storage_path: Pathlike, *args, **kwargs):
        self._storage_path = Path(storage_path)
        self._storage_path.mkdir(parents=True, exist_ok=True)

    @property
    def storage_path(self) -> str:
        return str(self._storage_path)

    def write(self, key: str, value) -> str:
        if not key.endswith((".jpg", ".jpeg", ".png", ".webp")):
            key = key + ".png"
        _as_pil(value).save(self._storage_path / key)
        return key


@register_reader
class PillowInMemoryReader(ImageReader):
    """Decodes image bytes attached to the manifest."""

    name = "pillow_memory"

    def __init__(self, *args, **kwargs):
        pass

    def read(self, raw_data: bytes, as_pil_image: bool = False):
        from PIL import Image as PILImage

        img = PILImage.open(BytesIO(raw_data))
        if as_pil_image:
            return img
        return np.asarray(img)


@register_writer
class PillowInMemoryWriter(ImageWriter):
    """Encodes images to PNG bytes attached to the manifest."""

    name = "pillow_memory"

    def __init__(self, *args, **kwargs):
        pass

    @property
    def storage_path(self) -> None:
        return None

    def write(self, key: str, value) -> bytes:
        buf = BytesIO()
        _as_pil(value).save(buf, format="PNG")
        return buf.getvalue()
