"""
The port's encoder (lhotse_tpu_torch.models.encoder) on the CPU against the
JAX package's (lhotse_tpu.models.encoder, on JAX's CPU backend) with the
same weights: JAX ``init_params(PRNGKey(0))`` copied in by
``encoder_state_from_jax``, and the same seeded numpy features. The small
configuration is tests/test_models.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhotse_tpu.models import encoder as J
from lhotse_tpu_torch.convert import _flatten, encoder_state_from_jax
from lhotse_tpu_torch.models import encoder as P

SMALL = dict(num_layers=2, d_model=64, num_heads=4, ffn_dim=128)
# Max-abs tolerances, with the maxima measured over this file's cases beside
# them. float32: the same products summed in other orders. bfloat16: one
# rounding of a hidden state near 4 is 2**-5; tests/test_models.py holds
# JAX's own bf16 forward to 2e-2 against itself with other padding.
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}  # measured 1.3e-6, 3.1e-2
LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}  # measured 1.2e-7, 3.1e-4
SGD_TOL = 1e-6  # parameters after one float32 step at lr 1e-2; measured 3.0e-8
# AdamW, on the updates since the start after each of three steps at lr
# 1e-3. Adam divides each gradient by its own magnitude, so an element whose
# first gradient is near eps (1e-8) may move by up to lr on a rounding
# difference (on the card, one element of w2 did, by 0.21 lr against the
# CPU). The elements whose first gradient exceeds ADAMW_WELL_GRAD (all but
# 25 of 76,880) are held tight: max-abs, and per parameter the norm of the
# difference over the norm of the update (an lr 1 % off moves these by
# 1e-2 and ~3e-5). The rest are held to lr.
ADAMW_WELL_GRAD = 1e-6
ADAMW_WELL_ATOL = 1e-5  # measured 1.5e-6
ADAMW_WELL_RTOL = 1e-3  # measured 3.4e-5
ADAMW_NEAR_EPS_LR = 1.0  # in units of lr; measured 6.3e-3


def _configs(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return J.EncoderConfig(**SMALL, dtype=jdt), P.EncoderConfig(**SMALL, dtype=dtype)


@pytest.fixture(scope="module")
def jax_params():
    return J.init_params(jax.random.PRNGKey(0), J.EncoderConfig(**SMALL))


def _port(jax_params, dtype):
    enc = P.Encoder(_configs(dtype)[1], device="cpu")
    encoder_state_from_jax(enc, jax_params)
    return enc


def _batch(seed=0, b=3, t=50, lens=(50, 30, 7)):
    feats = np.random.RandomState(seed).randn(b, t, 80).astype(np.float32)
    return feats, np.array(lens, np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _params_err(jax_tree, enc) -> float:
    ours = dict(enc.named_parameters())
    return max(float(np.abs(np.asarray(v) - ours[k].detach().numpy()).max())
               for k, v in _flatten(jax_tree).items())


def _update_errs(start, jax_tree, enc, first_grads) -> tuple:
    """The two updates since ``start`` against each other, split by the
    first step's gradient: over the elements past ``ADAMW_WELL_GRAD``, the
    max-abs difference and the largest per-parameter norm of the difference
    over the norm of the JAX update; over the others, the max-abs difference."""
    ours, start = dict(enc.named_parameters()), _flatten(start)
    well_abs = well_rel = near_abs = 0.0
    for k, v in _flatten(jax_tree).items():
        theirs = np.asarray(v) - np.asarray(start[k])
        diff = ours[k].detach().numpy() - np.asarray(start[k]) - theirs
        well = first_grads[k] > ADAMW_WELL_GRAD
        well_abs = max(well_abs, float(np.abs(diff[well]).max(initial=0.0)))
        well_rel = max(well_rel, float(np.linalg.norm(diff[well]) / np.linalg.norm(theirs[well])))
        near_abs = max(near_abs, float(np.abs(diff[~well]).max(initial=0.0)))
    return well_abs, well_rel, near_abs


@pytest.mark.parametrize("max_len,d_model", [(4096, 256), (4096, 64), (17, 6)])
def test_sinusoidal_positions_equal_jax(max_len, d_model):
    assert np.array_equal(P._sinusoidal_positions(max_len, d_model),
                          J._sinusoidal_positions(max_len, d_model))


def test_config_defaults_equal_jax():
    ours, theirs = P.EncoderConfig(), J.EncoderConfig()
    for name in ("num_mel_bins", "d_model", "num_heads", "num_layers", "ffn_dim", "max_len",
                 "mask_prob", "head_dim"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert ours.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16


def test_config_refuses_heads_that_do_not_divide_d_model():
    with pytest.raises(ValueError, match="num_heads"):
        P.Encoder(P.EncoderConfig(d_model=64, num_heads=5), device="cpu")


def test_parameters_have_the_jax_names_and_shapes(jax_params):
    enc = P.Encoder(P.EncoderConfig(**SMALL), device="cpu")
    ours = {k: tuple(v.shape) for k, v in enc.named_parameters()}
    theirs = {k: tuple(v.shape) for k, v in _flatten(jax_params).items()}
    assert ours == theirs
    assert all(p.dtype == torch.float32 for p in enc.parameters())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_jax(jax_params, dtype):
    jcfg, _ = _configs(dtype)
    feats, lens = _batch()
    want = np.asarray(J.forward(jax_params, feats, lens, jcfg), np.float32)
    enc = _port(jax_params, dtype)
    with torch.no_grad():
        got = enc(_t(feats), _t(lens).long())
    assert got.dtype == dtype and got.shape == (3, 50, 64)
    assert np.abs(got.float().numpy() - want).max() <= FWD_TOL[dtype]
    # No lengths: every frame attends everywhere.
    want = np.asarray(J.forward(jax_params, feats, None, jcfg), np.float32)
    with torch.no_grad():
        got = P.forward(enc, _t(feats))
    assert np.abs(got.float().numpy() - want).max() <= FWD_TOL[dtype]


def test_padding_invariance(jax_params):
    """Frames past feat_lens do not reach the real frames (the bound of
    tests/test_models.py's twin)."""
    enc = _port(jax_params, torch.bfloat16)
    feats, _ = _batch(seed=1, b=1, t=40, lens=(30,))
    lens = torch.tensor([30])
    garbage = feats.copy()
    garbage[0, 30:] = 999.0
    with torch.no_grad():
        a, b = enc(_t(feats), lens), enc(_t(garbage), lens)
    torch.testing.assert_close(a[0, :30].float(), b[0, :30].float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_prediction_loss_matches_jax(jax_params, dtype):
    """The port takes the mask that jax.random.bernoulli drew in JAX's loss."""
    jcfg, _ = _configs(dtype)
    feats, lens = _batch(seed=2, b=4, t=32, lens=(32, 20, 32, 11))
    key = jax.random.PRNGKey(3)
    mask = np.asarray(jax.random.bernoulli(key, jcfg.mask_prob, (4, 32)))
    want = float(J.masked_prediction_loss(jax_params, feats, lens, key, jcfg))
    enc = _port(jax_params, dtype)
    with torch.no_grad():
        got = float(P.masked_prediction_loss(enc, _t(feats), _t(lens).long(), _t(mask)))
    assert abs(got - want) <= LOSS_RTOL[dtype] * want


def test_sgd_step_matches_jax(jax_params):
    jcfg, _ = _configs(torch.float32)
    feats, lens = _batch(seed=2, b=4, t=32, lens=(32, 20, 32, 11))
    key = jax.random.PRNGKey(3)
    mask = _t(jax.random.bernoulli(key, jcfg.mask_prob, (4, 32)))
    new_params, want = J.sgd_train_step(jax_params, feats, lens, key, jcfg, lr=1e-2)
    enc = _port(jax_params, torch.float32)
    got = P.sgd_train_step(enc, _t(feats), _t(lens).long(), mask, lr=1e-2)
    assert abs(float(got) - float(want)) <= LOSS_RTOL[torch.float32] * float(want)
    assert _params_err(new_params, enc) <= SGD_TOL
    assert _params_err(jax_params, enc) > 100 * SGD_TOL  # the step moved them


def test_adamw_steps_match_optax(jax_params):
    jcfg, _ = _configs(torch.float32)
    feats, lens = _batch(seed=2, b=4, t=32, lens=(32, 20, 32, 11))
    key = jax.random.PRNGKey(3)
    j_init, j_step = J.make_adamw_train_step(jcfg, lr=1e-3)
    p_init, p_step = P.make_adamw_train_step(lr=1e-3)
    params, state = jax_params, j_init(jax_params)
    enc = _port(jax_params, torch.float32)
    opt = p_init(enc)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        mask = _t(jax.random.bernoulli(k, jcfg.mask_prob, (4, 32)))
        params, state, want = j_step(params, state, feats, lens, k)
        got = p_step(enc, opt, _t(feats), _t(lens).long(), mask)
        if i == 0:  # the step leaves its gradients in .grad
            first_grads = {n: p.grad.abs().numpy().copy() for n, p in enc.named_parameters()}
        assert abs(float(got) - float(want)) <= LOSS_RTOL[torch.float32] * float(want), i
        well_abs, well_rel, near_abs = _update_errs(jax_params, params, enc, first_grads)
        assert well_abs <= ADAMW_WELL_ATOL and well_rel <= ADAMW_WELL_RTOL, (i, well_abs, well_rel)
        assert near_abs <= ADAMW_NEAR_EPS_LR * 1e-3, (i, near_abs)
    assert sum(int((g <= ADAMW_WELL_GRAD).sum()) for g in first_grads.values()) < 100


def test_adamw_takes_optax_defaults():
    opt = P.make_adamw_train_step(lr=3e-4)[0](P.Encoder(P.EncoderConfig(**SMALL), device="cpu"))
    d = opt.defaults
    assert (d["lr"], d["betas"], d["eps"], d["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 1e-4)


def test_loss_decreases():
    """tests/test_models.py's training check on the port (bf16, SGD)."""
    enc = P.Encoder(P.EncoderConfig(**SMALL), device="cpu")
    feats = torch.from_numpy(np.random.RandomState(2).randn(4, 32, 80).astype(np.float32))
    lens = torch.full((4,), 32)
    gen = torch.Generator().manual_seed(3)
    masks = [P.draw_mask(lens, 32, enc.cfg.mask_prob, gen) for _ in range(11)]
    with torch.no_grad():
        loss0 = float(P.masked_prediction_loss(enc, feats, lens, masks[0]))
    for i in range(10):
        loss = P.sgd_train_step(enc, feats, lens, masks[i + 1], lr=1e-2)
    assert float(loss) < loss0


def test_draw_mask():
    lens = torch.tensor([100, 40, 0])
    a = P.draw_mask(lens, 100, 0.3, torch.Generator().manual_seed(0))
    b = P.draw_mask(lens, 100, 0.3, torch.Generator().manual_seed(0))
    assert a.dtype == torch.bool and a.shape == (3, 100) and torch.equal(a, b)
    assert not a[1, 40:].any() and not a[2].any()
    assert 15 <= int(a[0].sum()) <= 45


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default is the tanh approximation; torch's is erf."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(x))
    tanh_form = torch.nn.functional.gelu(_t(x), approximate="tanh").numpy()
    assert np.abs(tanh_form - want).max() <= 1e-6
    assert np.abs(torch.nn.functional.gelu(_t(x)).numpy() - want).max() > 1e-4


@pytest.mark.parametrize("fault", ["extra", "missing", "shape", "dtype"])
def test_convert_rejects_a_wrong_tree(jax_params, fault):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    tree = {**tree, "layers": [dict(layer) for layer in tree["layers"]]}
    if fault == "extra":
        tree["layers"][1]["wq"] = tree["layers"][1]["wqkv"]
    elif fault == "missing":
        del tree["layers"][1]["b2"]
    elif fault == "shape":
        tree["layers"][1]["wo"] = tree["layers"][1]["wo"][:, :, :32]
    else:
        tree["layers"][1]["w1"] = tree["layers"][1]["w1"].astype(np.float64)
    enc = P.Encoder(P.EncoderConfig(**SMALL), generator=_gen(5), device="cpu")
    before = {k: v.detach().clone() for k, v in enc.named_parameters()}
    with pytest.raises(KeyError if fault in ("extra", "missing") else ValueError):
        encoder_state_from_jax(enc, tree)
    assert all(torch.equal(before[k], v) for k, v in enc.named_parameters())


def test_seeded_weights_are_reproducible():
    a = P.Encoder(P.EncoderConfig(**SMALL), generator=_gen(1), device="cpu")
    b = P.init_params(_gen(1), P.EncoderConfig(**SMALL), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_encoder_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        P.Encoder(P.EncoderConfig(**SMALL))
