"""
The port's rank discovery and per-rank placement
(lhotse_tpu_torch.parallel.mesh) on the CPU, against the JAX package's
``pad_to_multiple`` and its env-first rank discovery.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lhotse_tpu.dataset import dataloading as J_loading
from lhotse_tpu.parallel import mesh as J
from lhotse_tpu_torch import parallel as P


@pytest.fixture
def no_env(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)


def test_env_comes_first(no_env, monkeypatch):
    assert (P.get_world_size(), P.get_rank()) == (1, 0)
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert (P.get_world_size(), P.get_rank()) == (8, 5)
    assert (J.get_world_size(), J.get_rank()) == (8, 5)
    assert (J_loading.get_world_size(), J_loading.get_rank()) == (8, 5)


def test_process_group_comes_after_env(no_env, monkeypatch, tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        assert dist.is_initialized()
        assert (P.get_world_size(), P.get_rank()) == (dist.get_world_size(), dist.get_rank())
        monkeypatch.setattr(dist, "get_world_size", lambda: 4)
        monkeypatch.setattr(dist, "get_rank", lambda: 3)
        assert (P.get_world_size(), P.get_rank()) == (4, 3)
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        assert (P.get_world_size(), P.get_rank()) == (2, 1)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("size,multiple,axis", [(5, 4, 0), (8, 4, 0), (3, 1, 0), (7, 3, 1), (0, 2, 0)])
def test_pad_to_multiple_equals_jax(size, multiple, axis):
    shape = [2, 3]
    shape[axis] = size
    arr = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    ours = P.pad_to_multiple(arr, multiple, axis=axis, value=-1.0)
    assert np.array_equal(ours, J.pad_to_multiple(arr, multiple, axis=axis, value=-1.0))
    assert ours.shape[axis] % multiple == 0


def test_shard_batch_pads_to_the_world_size_and_places(no_env, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    batch = {"inputs": np.ones((5, 7), np.float32), "lens": np.arange(1, 6),
             "ids": ["a", "b", "c", "d", "e"], "nested": [np.zeros((4, 2), np.int16)]}
    placed = P.shard_batch(batch, device="cpu")
    assert isinstance(placed["inputs"], torch.Tensor) and placed["inputs"].shape == (8, 7)
    assert placed["inputs"][5:].abs().sum() == 0 and placed["inputs"][:5].eq(1).all()
    assert placed["lens"].tolist() == [1, 2, 3, 4, 5, 0, 0, 0]
    assert placed["ids"] == batch["ids"]
    assert placed["nested"][0].shape == (4, 2) and placed["nested"][0].dtype == torch.int16
    out, device = P.host_local_to_global(batch, device="cpu")
    assert device == torch.device("cpu")
    assert all(torch.equal(out[k], placed[k]) for k in ("inputs", "lens"))


def test_placement_defaults_to_this_ranks_card(no_env, monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    from lhotse_tpu_torch.parallel import mesh

    assert mesh._local_device() == torch.device("cuda", 3)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        P.shard_batch({"x": np.ones((2, 2), np.float32)})
