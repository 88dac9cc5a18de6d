"""
The port's image manifests (``lhotse_tpu_torch/image``), their wiring into
``serialization.py``, ``custom.py``, ``DataCut.attach_image`` and
``collate_images``, against the JAX package's on the same seeded pixels:
the stored bytes (PNG files and in-memory PNG payloads), the manifests and
the pixels read back are equal exactly, but where the port keeps a JAX
fault out (ROADMAP C2).
"""
import numpy as np
import pytest
from PIL import Image as PILImage

import lhotse_tpu as J
from lhotse_tpu.dataset.collation import collate_custom_field as jcollate_custom_field
from lhotse_tpu.dataset.collation import collate_images as jcollate_images
from lhotse_tpu.image import io as jio
from lhotse_tpu.serialization import deserialize_item as jdeserialize_item
from lhotse_tpu.testing.dummies import dummy_cut as jdummy_cut
from lhotse_tpu_torch import Image
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.collation import collate_custom_field, collate_images
from lhotse_tpu_torch.image import io as pio
from lhotse_tpu_torch.serialization import deserialize_item
from lhotse_tpu_torch.testing.dummies import dummy_cut


def _pixels(seed: int, shape=(24, 32, 3)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _dict(image) -> dict:
    return image.to_dict()


@pytest.mark.parametrize("shape", [(24, 32, 3), (17, 9), (8, 8, 4)], ids=["rgb", "gray", "rgba"])
def test_pillow_files_bytes_manifest_and_pixels_equal_jax(tmp_path, shape):
    pixels = _pixels(1, shape)
    with pio.PillowWriter(tmp_path / "port") as w:
        ours = w.store_image("pic", pixels)
    with jio.PillowWriter(tmp_path / "jax") as w:
        theirs = w.store_image("pic", pixels)
    assert isinstance(ours, Image) and ours.storage_key == "pic.png"
    assert (tmp_path / "port" / "pic.png").read_bytes() == (tmp_path / "jax" / "pic.png").read_bytes()
    assert ({**_dict(ours), "storage_path": None} == {**_dict(theirs), "storage_path": None})
    assert ours.shape == theirs.shape == shape[:2]
    assert np.array_equal(ours.load(), theirs.load())
    assert np.array_equal(ours.load(), pixels)
    assert np.array_equal(np.asarray(ours.load(as_pil_image=True)), pixels)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares what each package raises
        return type(e).__name__, str(e)


def test_encoded_bytes_are_stored_where_jax_raises(tmp_path):
    """``attach_image`` and ``ImageWriter.store_image`` take encoded bytes
    too: JAX passes them on as if they were an image and raises
    ``AttributeError`` at ``pil.width``; the port decodes them (ROADMAP C2),
    as the writers' own ``write`` does in both packages."""
    pixels = _pixels(2)
    path = tmp_path / "in.png"
    PILImage.fromarray(pixels).save(path)
    blob = path.read_bytes()
    theirs = _raised(lambda: jio.PillowInMemoryWriter().store_image("k", blob))
    assert theirs is not None and theirs[0] == "AttributeError"
    assert _raised(lambda: jdummy_cut(0).attach_image("image", blob))[0] == "AttributeError"
    ours = pio.PillowInMemoryWriter().store_image("k", blob)
    assert _dict(ours) == _dict(jio.PillowInMemoryWriter().store_image("k", pixels))
    with pio.PillowWriter(tmp_path / "port") as w:
        assert np.array_equal(w.store_image("b", blob).load(), pixels)
    cut = dummy_cut(0).attach_image("image", blob)
    assert cut.to_dict() == jdummy_cut(0).attach_image("image", pixels).to_dict()
    assert np.array_equal(cut.load_image(), pixels)
    assert np.array_equal(jio.PillowInMemoryReader().read(jio.PillowInMemoryWriter().write(
        "k", blob)), pixels)


@pytest.mark.parametrize("source", ["array", "pil", "path"])
def test_pillow_memory_payload_equals_jax(tmp_path, source):
    pixels = _pixels(2)
    path = tmp_path / "in.png"
    PILImage.fromarray(pixels).save(path)
    value = {"array": pixels, "pil": PILImage.fromarray(pixels), "path": path}[source]
    ours = pio.PillowInMemoryWriter().store_image("k", value)
    theirs = jio.PillowInMemoryWriter().store_image("k", value)
    assert ours.is_in_memory and isinstance(ours.storage_key, bytes)
    assert _dict(ours) == _dict(theirs)
    assert np.array_equal(ours.load(), theirs.load())
    assert np.array_equal(ours.load(), pixels)
    assert repr(ours) == repr(theirs)


def test_backend_registry_equals_jax():
    assert pio.available_storage_backends() == jio.available_storage_backends()
    for name in pio.available_storage_backends():
        assert pio.get_reader(name).__name__ == jio.get_reader(name).__name__
        assert pio.get_writer(name).__name__ == jio.get_writer(name).__name__
    assert pio.get_memory_writer("pillow_memory") is pio.PillowInMemoryWriter
    assert pio.is_in_memory("pillow_memory") and not pio.is_in_memory("pillow_files")


def test_manifest_round_trip_move_to_memory_and_prefix_equal_jax(tmp_path):
    pixels = _pixels(3)
    with pio.PillowWriter(tmp_path) as w:
        ours = w.store_image("pic", pixels)
    theirs = J.Image.from_dict(ours.to_dict())
    again = deserialize_item(ours.to_dict())
    assert isinstance(again, Image) and again == ours
    assert _dict(jdeserialize_item(ours.to_dict())) == _dict(again)
    # A key-only in-memory dict gets storage_path None in both.
    mem = pio.PillowInMemoryWriter().store_image("k", pixels).to_dict()
    del mem["storage_path"]
    assert _dict(Image.from_dict(dict(mem))) == _dict(J.Image.from_dict(dict(mem)))
    moved, jmoved = ours.move_to_memory(), theirs.move_to_memory()
    assert _dict(moved) == _dict(jmoved) and moved.move_to_memory() is moved
    assert np.array_equal(moved.load(), pixels)
    prefixed = Image(storage_type="pillow_files", storage_path="imgs", storage_key="pic.png",
                     width=32, height=24).with_path_prefix(tmp_path)
    jprefixed = J.Image(storage_type="pillow_files", storage_path="imgs", storage_key="pic.png",
                        width=32, height=24).with_path_prefix(tmp_path)
    assert _dict(prefixed) == _dict(jprefixed)
    assert Image.from_pillow(PILImage.fromarray(pixels)).to_dict() == _dict(
        J.Image.from_pillow(PILImage.fromarray(pixels)))


@pytest.mark.parametrize("how", ["array", "path"])
def test_attach_image_and_custom_loading_equal_jax(tmp_path, how):
    pixels = _pixels(4)
    path = tmp_path / "img.png"
    PILImage.fromarray(pixels).save(path)
    value = {"array": pixels, "path": str(path)}[how]
    ours = dummy_cut(0).attach_image("image", value)
    theirs = jdummy_cut(0).attach_image("image", value)
    assert ours.to_dict() == theirs.to_dict()
    assert np.array_equal(ours.load_image(), theirs.load_image())
    assert np.array_equal(ours.load_custom("image"), pixels)
    assert "image" in dict(ours.iter_data())
    restored = CutSet.from_dicts([ours.to_dict()])[0]
    assert isinstance(restored.image, Image)
    assert np.array_equal(restored.load_image(), pixels)


def test_image_manifests_in_a_cut_manifest_file(tmp_path):
    """A cut with a file-backed image survives a JSONL round trip, and the
    port reads the file back as JAX does."""
    with pio.PillowWriter(tmp_path / "imgs") as w:
        image = w.store_image("a", _pixels(5))
    cut = dummy_cut(0)
    cut.image = image
    CutSet.from_cuts([cut]).to_file(tmp_path / "cuts.jsonl")
    ours = CutSet.from_file(tmp_path / "cuts.jsonl")[0]
    theirs = J.CutSet.from_file(tmp_path / "cuts.jsonl")[0]
    assert ours.to_dict() == theirs.to_dict()
    assert np.array_equal(ours.load_image(), theirs.load_image())


def test_collate_images_and_custom_field_equal_jax():
    pixels = [_pixels(10 + i) for i in range(3)]
    ours = CutSet.from_cuts(dummy_cut(i).attach_image("image", p) for i, p in enumerate(pixels))
    theirs = J.CutSet.from_cuts(
        jdummy_cut(i).attach_image("image", p) for i, p in enumerate(pixels))
    batch = collate_images(ours)
    assert batch.shape == (3, 24, 32, 3) and batch.dtype == np.uint8
    assert np.array_equal(batch, jcollate_images(theirs))
    assert np.array_equal(batch, np.stack(pixels))
    assert np.array_equal(np.asarray(collate_custom_field(ours, "image")),
                          np.asarray(jcollate_custom_field(theirs, "image")))
