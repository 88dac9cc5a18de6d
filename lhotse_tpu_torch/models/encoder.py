"""
The Transformer speech encoder trained by masked log-mel prediction (port
of ``lhotse_tpu/models/encoder.py``): the model that the fbank frontend
feeds.

The computation is the JAX package's, step for step: an input projection
plus sinusoidal positions, pre-norm blocks of multi-head self-attention and
a tanh-GELU feed-forward, and a final layer norm. Parameters are float32;
the products run in ``cfg.dtype`` (bfloat16 by default), layer norms and
the softmax in float32. Attention is written out as scores → pad mask →
softmax → product, as in the JAX package, so the port's forward can be held
to it on the same weights.

The parameters keep the JAX shapes and names (``layers.0.wqkv`` is
``params["layers"][0]["wqkv"]``), so
:func:`lhotse_tpu_torch.convert.encoder_state_from_jax` copies a JAX
parameter tree in as it is.

Two defaults differ from PyTorch's and follow the JAX package's:
``jax.nn.gelu`` is the tanh approximation, and ``optax.adamw`` decays every
parameter by 1e-4 (PyTorch's ``AdamW`` default is 1e-2).

Tensor parallelism follows the JAX package's ``param_shardings``: over a
``DeviceMesh`` with dims ("data", "model"), attention heads and the
feed-forward's hidden units shard over "model" and the batch over "data".
Parameters placed as ``DTensor``s by :func:`param_shardings` run the same
forward through DTensor's sharding propagation; the attention core of each
block runs on each rank's own batch rows and heads (``local_map``), and
:func:`sgd_train_step` sums a gradient that comes back partial over a mesh
dim before the update. Plain tensors take the single-card path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default; torch.optim.AdamW's is 1e-2


@dataclass(frozen=True)
class EncoderConfig:
    num_mel_bins: int = 80
    d_model: int = 256
    num_heads: int = 8
    num_layers: int = 4
    ffn_dim: int = 1024
    max_len: int = 4096
    mask_prob: float = 0.3
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of num_heads {self.num_heads}.")
        return self.d_model // self.num_heads


def _sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """A copy of the JAX package's position table (float64 angles, float32 out)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(d_model // 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    out = np.zeros((max_len, d_model), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


class LayerNorm(nn.Module):
    """Layer norm in float32 (biased variance, eps 1e-6), cast back to the
    input's dtype; parameters ``scale`` and ``bias``."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        out = (x32 - mean) * torch.rsqrt(var + 1e-6)
        return (out * self.scale + self.bias).to(x.dtype)


def _dense(shape, fan_in: int, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) / np.sqrt(fan_in))


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pad_mask: torch.Tensor,
               head_dim: int) -> torch.Tensor:
    """Scores → pad mask → float32 softmax → context, over (b, t, h·K)
    queries, keys and values of ``h`` heads; gives (b, t, h·K)."""
    b, t, hk = q.shape
    q, k, v = (z.reshape(b, t, hk // head_dim, head_dim).transpose(1, 2) for z in (q, k, v))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim)
    scores = scores.masked_fill(~pad_mask[:, None, None, :], -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(b, t, hk)


def _attention_placements(mesh) -> Tuple[Tuple[Placement, ...], Tuple[Placement, ...]]:
    """The placements :func:`_attention` runs under on a ("data", "model")
    mesh: q, k, v and the context sharded by batch rows over "data" and by
    heads over "model"; the pad mask by rows. Each rank then attends over
    its own rows and heads, and DTensor need not plan the products."""
    heads = tuple(Shard(0) if n == "data" else Shard(2) for n in mesh.mesh_dim_names)
    rows = tuple(Shard(0) if n == "data" else Replicate() for n in mesh.mesh_dim_names)
    return heads, rows


class Block(nn.Module):
    """Pre-norm self-attention and feed-forward, with residuals."""

    def __init__(self, cfg: EncoderConfig, generator: torch.Generator):
        super().__init__()
        d, H, K = cfg.d_model, cfg.num_heads, cfg.head_dim
        self.cfg = cfg
        self.ln1 = LayerNorm(d)
        self.wqkv = _dense((d, 3, H, K), d, generator)
        self.wo = _dense((H, K, d), d, generator)
        self.ln2 = LayerNorm(d)
        self.w1 = _dense((d, cfg.ffn_dim), d, generator)
        self.b1 = nn.Parameter(torch.zeros(cfg.ffn_dim))
        self.w2 = _dense((cfg.ffn_dim, d), cfg.ffn_dim, generator)
        self.b2 = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        d = x.shape[-1]
        H, K = cfg.num_heads, cfg.head_dim
        # Self-attention: q, k and v as (b, t, d) @ (d, H·K), one product each,
        # so that heads sharded over "model" stay one contiguous range.
        h = self.ln1(x)
        q, k, v = (torch.matmul(h, self.wqkv[:, i].to(dt).reshape(d, H * K)) for i in range(3))
        attend = _attention
        if isinstance(q, DTensor):
            heads, rows = _attention_placements(q.device_mesh)
            attend = local_map(_attention, out_placements=(heads,),
                               in_placements=(heads, heads, heads, rows, None),
                               redistribute_inputs=True)
        ctx = attend(q, k, v, pad_mask, K)
        x = x + torch.matmul(ctx, self.wo.to(dt).reshape(H * K, d))
        # Feed-forward.
        h = self.ln2(x)
        h = torch.matmul(h, self.w1.to(dt)) + self.b1.to(dt)
        h = F.gelu(h, approximate="tanh")
        h = torch.matmul(h, self.w2.to(dt)) + self.b2.to(dt)
        return x + h


class Encoder(nn.Module):
    """
    Encode a feature batch: (B, T, F) → (B, T, d_model) hidden states in
    ``cfg.dtype``. Frames at or past ``feat_lens`` are masked out of
    attention.

    :param generator: the CPU ``torch.Generator`` the weights are drawn from
        (fan-in scaled normals; layer norms at 1 and 0, biases at 0), as
        ``init_params`` draws them in JAX from its key; one seeded with 0
        when not given.
    :param device: where the module lives: the card unless the caller asks
        for another device. The draws are made on the CPU first, so a
        generator gives the same weights on every device.
    """

    def __init__(self, cfg: EncoderConfig = EncoderConfig(), *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        nm, d = cfg.num_mel_bins, cfg.d_model
        self.input_proj = _dense((nm, d), nm, generator)
        self.mask_embed = nn.Parameter(torch.randn(nm, generator=generator) * 0.1)
        self.output_proj = _dense((d, nm), d, generator)
        self.final_ln = LayerNorm(d)
        self.layers = nn.ModuleList(Block(cfg, generator) for _ in range(cfg.num_layers))
        self.register_buffer(
            "positions", torch.from_numpy(_sinusoidal_positions(cfg.max_len, d)), persistent=False)
        self.to(device)

    def forward(self, feats: torch.Tensor, feat_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = feats.shape
        dt = self.cfg.dtype
        if feat_lens is None:
            pad_mask = torch.ones((b, t), dtype=torch.bool, device=feats.device)
        else:
            pad_mask = _valid(feat_lens, t)
        x = torch.matmul(feats.to(dt), self.input_proj.to(dt))
        x = x + self.positions[:t].to(dt)[None]
        for layer in self.layers:
            x = layer(x, pad_mask)
        return self.final_ln(x)


def _valid(feat_lens: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=feat_lens.device)[None, :] < feat_lens[:, None]


def init_params(generator: torch.Generator, cfg: EncoderConfig = EncoderConfig(),
                device="cuda") -> Encoder:
    """An :class:`Encoder` with weights drawn from ``generator`` (the
    counterpart of the JAX ``init_params(key, cfg)``)."""
    return Encoder(cfg, generator=generator, device=device)


def forward(encoder: Encoder, feats: torch.Tensor,
            feat_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``encoder(feats, feat_lens)``, under the JAX package's function name."""
    return encoder(feats, feat_lens)


def draw_mask(feat_lens: torch.Tensor, t: int, mask_prob: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The frames to mask: a Bernoulli(``mask_prob``) draw over (B, t), kept
    where the frame is real. The draw is made on the generator's device and
    the mask returned on ``feat_lens``'s."""
    gen_device = generator.device if generator is not None else feat_lens.device
    draw = torch.rand((feat_lens.shape[0], t), generator=generator, device=gen_device) < mask_prob
    return draw.to(feat_lens.device) & _valid(feat_lens, t)


def masked_prediction_loss(encoder: Encoder, feats: torch.Tensor, feat_lens: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """
    Masked feature prediction: the frames in ``mask`` (from
    :func:`draw_mask`) are replaced by the learned mask embedding, the batch
    is encoded, and the original log-mels are regressed at the masked real
    frames (float32 MSE over the mel bins, averaged over those frames).
    """
    t = feats.shape[1]
    mask = mask & _valid(feat_lens, t)
    masked_inputs = torch.where(mask[..., None], encoder.mask_embed[None, None, :], feats)
    hidden = encoder(masked_inputs, feat_lens)
    pred = torch.matmul(hidden, encoder.output_proj.to(encoder.cfg.dtype)).float()
    err = (pred - feats.float()).square().mean(-1)
    denom = mask.sum().clamp_min(1)
    return (err * mask).sum() / denom


def sgd_train_step(encoder: Encoder, feats: torch.Tensor, feat_lens: torch.Tensor,
                   mask: torch.Tensor, lr: float = 1e-3) -> torch.Tensor:
    """One SGD step of the masked-prediction objective, ``p -= lr * g`` in
    place. Returns the loss before the step. With parameters placed by
    :func:`param_shardings`, pass the batch as ``DTensor``s sharded by rows
    over "data" (:func:`lhotse_tpu_torch.parallel.mesh.local_rows`) and run
    the step under DTensor's ``implicit_replication``."""
    params = list(encoder.parameters())
    loss = masked_prediction_loss(encoder, feats, feat_lens, mask)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            if isinstance(g, DTensor):
                # Sums the rows' partial gradients over "data" (and, for a
                # replicated parameter, the heads' over "model").
                g = g.redistribute(g.device_mesh, p.placements)
            p.sub_(lr * g)
    return loss.detach()


def make_adamw_train_step(lr: float = 1e-3) -> Tuple[Callable, Callable]:
    """
    AdamW with ``optax.adamw(lr)``'s defaults (betas (0.9, 0.999), eps 1e-8,
    weight decay 1e-4 on every parameter). Returns ``(init, step)``:
    ``init(encoder)`` makes the optimizer, ``step(encoder, opt, feats,
    feat_lens, mask)`` takes one step in place and returns the loss before it.
    The loss runs at the encoder's own configuration.
    """

    def init(encoder: Encoder) -> torch.optim.AdamW:
        return torch.optim.AdamW(encoder.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=ADAMW_WEIGHT_DECAY)

    def step(encoder: Encoder, opt: torch.optim.AdamW, feats, feat_lens, mask) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = masked_prediction_loss(encoder, feats, feat_lens, mask)
        loss.backward()
        opt.step()
        return loss.detach()

    return init, step


# The tensor-parallel placement of each block parameter over "model" (JAX
# models/encoder.py:param_shardings): heads of wqkv (d, 3, H, K) and wo
# (H, K, d), the hidden units of w1 (d, ffn), b1 (ffn,) and w2 (ffn, d).
_MODEL_SHARDED_DIM = {"wqkv": 2, "wo": 0, "w1": 1, "b1": 0, "w2": 0}


def param_shardings(encoder: Encoder, mesh) -> Dict[str, Tuple[Placement, ...]]:
    """
    The placements of every parameter of ``encoder`` (by name, as
    ``layers.0.wqkv``) over a ``DeviceMesh`` with dims ("data", "model"):
    attention heads and the feed-forward's hidden units shard over "model",
    everything else is replicated, and every parameter is replicated over
    "data" (the batch shards there). Place a parameter with
    ``distribute_tensor(p, mesh, placements)``.
    """
    out = {}
    for name, _ in encoder.named_parameters():
        dim = _MODEL_SHARDED_DIM.get(name.rsplit(".", 1)[-1]) if name.startswith("layers.") else None
        out[name] = tuple(
            Shard(dim) if axis == "model" and dim is not None else Replicate()
            for axis in mesh.mesh_dim_names)
    return out
