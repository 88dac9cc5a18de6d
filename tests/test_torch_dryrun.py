"""
The port's data-parallel path (lhotse_tpu_torch.entry.dryrun_multichip and
its helpers, models.encoder.param_shardings, parallel.mesh.local_rows)
against the JAX package's (__graft_entry__.py, models/encoder.py): the same
parameter placements, the same per-rank sampler partitions and features,
and a tensor-parallel SGD step over spawned gloo ranks on the CPU equal to
the single-process step within tests/test_torch_encoder.py's bounds
(float32 1e-5, bf16 5e-2).
"""
import copy
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import __graft_entry__ as jentry
from lhotse_tpu.models import encoder as jenc
from lhotse_tpu_torch import entry
from lhotse_tpu_torch.convert import encoder_state_from_jax
from lhotse_tpu_torch.models.encoder import (
    Encoder, EncoderConfig, draw_mask, param_shardings, sgd_train_step)
from test_torch_extractors import TOL

STEP_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def one_rank_mesh():
    """A ("data", "model") mesh over a process group of this process alone."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _sharded_axes_jax(spec) -> dict:
    return {i: axis for i, axis in enumerate(spec) if axis is not None}


def test_param_shardings_equal_jax(one_rank_mesh):
    """Per parameter, the dim sharded over "model" is the one JAX's
    PartitionSpec shards on the conftest's 8-device (4 x 2) mesh, and
    nothing is sharded over "data"."""
    cfg = entry.DRYRUN_CONFIG
    jcfg = jenc.EncoderConfig(num_layers=2, d_model=64, num_heads=4, ffn_dim=128)
    jparams = jenc.init_params(jax.random.PRNGKey(0), jcfg)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    jspecs = jax.tree_util.tree_flatten_with_path(jenc.param_shardings(jparams, jmesh))[0]
    want = {}
    for path, sharding in jspecs:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        want[name] = _sharded_axes_jax(sharding.spec)
    ours = param_shardings(Encoder(cfg, device="cpu"), one_rank_mesh)
    assert set(ours) == set(want)
    sharded = 0
    for name, placements in ours.items():
        data, model = placements
        assert data.is_replicate(), name
        got = {model.dim: "model"} if model.is_shard() else {}
        assert got == want[name], name
        sharded += bool(got)
    assert sharded == 5 * cfg.num_layers


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip_passes(n_devices, tmp_path, monkeypatch):
    """The dry-run over 4 (2 data x 2 model) and 8 (4 x 2) spawned ranks.
    The ranks start from this process's import path with JAX and the JAX
    package made unimportable, so a rank that imported either would fail."""
    for name in ("jax", "lhotse_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('a dry-run rank imported {name}')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    entry.dryrun_multichip(n_devices)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_sgd_step_equals_the_single_process_step(dtype):
    """A (2 data x 2 model) SGD step of an encoder with JAX's weights equals
    the single-process step on the same batch and mask."""
    cfg = EncoderConfig(num_layers=2, d_model=64, num_heads=4, ffn_dim=128, dtype=dtype)
    jcfg = jenc.EncoderConfig(num_layers=2, d_model=64, num_heads=4, ffn_dim=128)
    encoder = Encoder(cfg, device="cpu")
    encoder_state_from_jax(encoder, jenc.init_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((4, 48, 80)).astype(np.float32))
    feat_lens = torch.tensor([48, 40, 33, 48])
    mask = draw_mask(feat_lens, 48, cfg.mask_prob, torch.Generator().manual_seed(1))
    state = copy.deepcopy(encoder.state_dict())
    out = entry.run_gloo_ranks(entry.sharded_sgd_step_rank, 4, state, cfg, feats, feat_lens, mask)
    loss, params = out["loss"], out["params"]
    want_loss = sgd_train_step(encoder, feats, feat_lens, mask)
    tol = STEP_TOL[dtype]
    assert abs(float(loss) - float(want_loss)) <= tol
    want = dict(encoder.named_parameters())
    assert set(params) == set(want)
    want = {k: v.detach() for k, v in want.items()}
    worst = max(float((params[k] - want[k]).abs().max()) for k in want)
    assert worst <= tol, worst
    # In float32 the step moves the weights by far more than the two sides part.
    moved = max(float((want[k] - state[k]).abs().max()) for k in want)
    assert moved > 10 * worst or dtype == torch.bfloat16


@pytest.mark.parametrize("dp", [2, 4])
def test_rank_batches_real_features_equal_jax(dp):
    """The same cut ids per rank, and features within TOL["Fbank"] on the
    mel bins within 20 nats of each frame's peak. The dummy cuts are a pure
    1 kHz tone at full scale, whose leakage all but cancels in the bins
    further down (near -15 against a peak near 7): there every float32 route
    is rounding noise (against a float64 chain the port's CPU route is
    1.5e-3 off, JAX's host route 4.6e-3), as the log-spectrogram comparison
    of tests/test_torch_extractors.py finds."""
    ours = entry._rank_batches_real_features(dp, 2)
    theirs = jentry._rank_batches_real_features(dp, 2)
    assert len(ours) == len(theirs) == dp
    for (feats, lens, ids), (jfeats, jlens, jids) in zip(ours, theirs):
        assert ids == jids
        np.testing.assert_array_equal(lens, jlens)
        assert feats.shape == jfeats.shape
        ref = np.maximum(feats, jfeats)
        audible = ref > ref.max(axis=-1, keepdims=True) - 20.0
        assert audible.mean() > 0.5
        assert np.abs(feats - jfeats)[audible].max() <= TOL["Fbank"]


@pytest.mark.parametrize("world_size, num_workers", [(2, 2), (4, 2), (3, 1)])
def test_iterable_shar_coverage(world_size, num_workers, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "WORKER", "NUM_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    entry._check_iterable_shar_coverage(world_size, num_workers)
    jentry._check_iterable_shar_coverage(world_size, num_workers)
    assert not any(k in os.environ for k in ("RANK", "WORLD_SIZE", "WORKER", "NUM_WORKERS"))
