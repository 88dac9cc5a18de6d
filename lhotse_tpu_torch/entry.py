"""
The entry points of the port (counterpart of the JAX package's
``__graft_entry__``):

- :func:`entry`: raw audio through the 80-mel log-fbank layer (the fbank
  kernel for a CUDA tensor) into the Transformer encoder, on one card;

      fn, args = entry()            # on the card
      hidden, feat_lens = fn(*args)

- :func:`dryrun_multichip`: one tensor- and data-parallel training step over
  ``n`` ranks, fed by the library's distributed data paths. It is a
  placement check on the CPU: it spawns ``n`` processes joined by a gloo
  process group on ``localhost`` (the counterpart of the JAX package's
  self-provisioned CPU devices), so its caller needs no environment and no
  card, and the processes import neither JAX nor CUDA.
"""
from __future__ import annotations

import math
import os
import socket
import tempfile
from datetime import timedelta
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank
from lhotse_tpu_torch.models.encoder import Encoder, EncoderConfig

# The JAX entry's encoder and example batch: 4 clips of 4 s.
ENTRY_CONFIG = EncoderConfig(num_layers=2, d_model=128, num_heads=4, ffn_dim=512)
ENTRY_BATCH, ENTRY_SAMPLES = 4, 16000 * 4
# The JAX dry-run's encoder, batch rows per data rank and audio rows (0.25 s).
DRYRUN_CONFIG = EncoderConfig(num_layers=2, d_model=64, num_heads=4, ffn_dim=128)
DRYRUN_BATCH_PER_RANK = 2
DRYRUN_AUDIO_SAMPLES = 4000
# A collective that waits longer than this has lost a rank.
GLOO_TIMEOUT = timedelta(minutes=5)


def fbank_encode(audio: torch.Tensor, audio_lens: torch.Tensor, encoder: Encoder,
                 fbank: Wav2LogFilterBank) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    (B, N) float32 audio → (B, T, d_model) hidden states and the (B,) frame
    counts ``(audio_lens + 80) // 160`` (the snip_edges=False rule), which
    mask the padding out of attention.
    """
    feats = fbank(audio)
    feat_lens = (audio_lens + 80) // 160
    return encoder(feats, feat_lens), feat_lens


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """``(fbank_encode, (audio, audio_lens, encoder, fbank))`` on ``device``,
    at the JAX entry's configuration and example batch (numpy seed 0; the
    encoder's weights from a generator seeded with 0)."""
    rng = np.random.RandomState(0)
    audio = rng.randn(ENTRY_BATCH, ENTRY_SAMPLES).astype(np.float32) * 0.1
    lens = np.array([ENTRY_SAMPLES, ENTRY_SAMPLES - 400, ENTRY_SAMPLES, 32000], np.int64)
    encoder = Encoder(ENTRY_CONFIG, device=device)
    fbank = Wav2LogFilterBank(sampling_rate=16000, device=device)
    args = (torch.from_numpy(audio).to(device), torch.from_numpy(lens).to(device), encoder, fbank)
    return fbank_encode, args


# ---------------------------------------------------------------------------
# Ranks: spawned processes joined by a gloo process group
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_rank(rank: int, n_ranks: int, port: int, out_path: str, fn: Callable, args: tuple):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=n_ranks, timeout=GLOO_TIMEOUT)
    try:
        result = fn(rank, n_ranks, *args)
        if rank == 0:
            torch.save(result, out_path)
    finally:
        dist.destroy_process_group()


def run_gloo_ranks(fn: Callable, n_ranks: int, *args):
    """
    Run ``fn(rank, n_ranks, *args)`` in ``n_ranks`` spawned processes joined
    by a gloo process group on a free ``localhost`` port, and return what
    rank 0's call returned (tensors and plain Python values). A rank that
    raises ends every rank, and the error is raised here. ``fn`` must be
    importable by name; a spawned process starts from a fresh import, so a
    caller that has built a kernel has it on disk for the ranks to load.
    """
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.start_processes(
            _gloo_rank, args=(n_ranks, _free_port(), out_path, fn, args), nprocs=n_ranks,
            start_method="spawn")
        return torch.load(out_path, weights_only=True)


def _mesh(n_devices: int):
    """The ("data", "model") CPU mesh of the JAX dry-run: two model ranks
    when ``n_devices`` is even, one otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    tp = 2 if n_devices % 2 == 0 else 1
    return init_device_mesh("cpu", (n_devices // tp, tp), mesh_dim_names=("data", "model"))


def _sharded_sgd_step(encoder: Encoder, mesh, feats: torch.Tensor, feat_lens: torch.Tensor,
                      mask: torch.Tensor, lr: float = 1e-3) -> Tuple[torch.Tensor, Dict]:
    """
    Place ``encoder``'s parameters as ``DTensor``s by
    :func:`~lhotse_tpu_torch.models.encoder.param_shardings`, feed this data
    rank's rows of the global batch, and take one ``sgd_train_step``.
    Returns the loss and every updated parameter, gathered whole.
    """
    from torch.distributed.tensor import distribute_module, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from lhotse_tpu_torch.models.encoder import param_shardings, sgd_train_step
    from lhotse_tpu_torch.parallel.mesh import local_rows

    shardings = param_shardings(encoder, mesh)

    def place(name, module, device_mesh):
        for pname, p in list(module.named_parameters(recurse=False)):
            placements = shardings[f"{name}.{pname}" if name else pname]
            module.register_parameter(
                pname, nn.Parameter(distribute_tensor(p.detach(), device_mesh, placements)))

    distribute_module(encoder, mesh, place)
    # The encoder's own tensors (positions, frame ranges) join the DTensor
    # products as replicated.
    with implicit_replication():
        loss = sgd_train_step(encoder, local_rows(feats, mesh), local_rows(feat_lens, mesh),
                              local_rows(mask, mesh), lr=lr)
    return loss.full_tensor(), {
        name: p.detach().full_tensor() for name, p in encoder.named_parameters()}


def sharded_sgd_step_rank(rank: int, n_ranks: int, state: Dict[str, torch.Tensor],
                          cfg: EncoderConfig, feats: torch.Tensor, feat_lens: torch.Tensor,
                          mask: torch.Tensor, lr: float = 1e-3) -> Dict:
    """
    A rank's part of one ``sgd_train_step`` of an encoder with the weights
    ``state`` on the global batch ``(feats, feat_lens, mask)``, tensor- and
    data-parallel over the dry-run's mesh of ``n_ranks``; run it with
    ``run_gloo_ranks(sharded_sgd_step_rank, n, state, cfg, feats, feat_lens,
    mask)``. Returns ``{"loss", "params"}``, the updated weights gathered
    whole.
    """
    encoder = Encoder(cfg, device="cpu")
    encoder.load_state_dict(state)
    loss, params = _sharded_sgd_step(encoder, _mesh(n_ranks), feats, feat_lens, mask, lr)
    return {"loss": loss, "params": params}


# ---------------------------------------------------------------------------
# The dry-run body: library data paths feeding a sharded train step
# ---------------------------------------------------------------------------
def _rank_batches_real_features(dp: int, batch_per_rank: int) -> list:
    """
    The library's map-style data-parallel path for ``dp`` ranks, in one
    process: each rank's ``DynamicBucketingSampler`` over the same corpus
    with ``(rank, world_size)`` gives its first batch (the ranks' cuts
    disjoint), and ``OnTheFlyFeatures`` extracts real fbank features from
    the cuts' audio on the CPU. Returns per-rank ``(feats, feat_lens,
    cut_ids)``.
    """
    import warnings

    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import DynamicBucketingSampler
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.testing.dummies import dummy_cut

    n_cuts = dp * batch_per_rank * 4
    corpus = CutSet.from_cuts(
        dummy_cut(i, duration=1.0 + 0.01 * (i % 7), with_data=True) for i in range(n_cuts))
    per_rank = []
    for rank in range(dp):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the eager CutSet warning
            sampler = DynamicBucketingSampler(
                corpus, max_cuts=batch_per_rank, num_buckets=2, buffer_size=n_cuts, shuffle=True,
                seed=0, world_size=dp, rank=rank)
        batch = next(iter(sampler))
        if len(batch) != batch_per_rank:
            raise AssertionError(f"rank {rank} drew {len(batch)} cuts, expected {batch_per_rank}")
        per_rank.append(batch)
    seen = [frozenset(c.id for c in batch) for batch in per_rank]
    for a in range(dp):
        for b in range(a + 1, dp):
            overlap = seen[a] & seen[b]
            if overlap:
                raise AssertionError(
                    f"Ranks {a} and {b} drew overlapping cuts: {sorted(overlap)[:5]}")
    extract = OnTheFlyFeatures(Fbank(FbankConfig(device="cpu")))
    shaped = []
    for batch in per_rank:
        feats, feat_lens = extract(batch)[:2]
        shaped.append((np.asarray(feats), np.asarray(feat_lens), [c.id for c in batch]))
    return shaped


def _check_iterable_shar_coverage(world_size: int = 2, num_workers: int = 2) -> None:
    """
    The iterable-style data-parallel contract: Shar shards split per (rank,
    worker) by ``split_for_dataloading`` cover the corpus exactly once over
    the whole (rank × worker) grid, each cell read in turn in this process
    under its ``RANK``/``WORLD_SIZE``/``WORKER``/``NUM_WORKERS``.
    """
    from collections import Counter

    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.testing.dummies import dummy_recording

    grid_env = ("RANK", "WORLD_SIZE", "WORKER", "NUM_WORKERS")
    with tempfile.TemporaryDirectory() as tmp:
        n = 4 * world_size * num_workers
        cuts = CutSet.from_cuts(dummy_recording(i, with_data=True).to_cut() for i in range(n))
        all_ids = frozenset(c.id for c in cuts)
        cuts.to_shar(tmp, fields={"recording": "wav"}, shard_size=2, create_index=False)
        seen = Counter()
        saved = {k: os.environ.get(k) for k in grid_env}
        try:
            for rank in range(world_size):
                for worker in range(num_workers):
                    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                                      WORKER=str(worker), NUM_WORKERS=str(num_workers))
                    for c in CutSet.from_shar(in_dir=tmp, split_for_dataloading=True):
                        seen[c.id] += 1
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    if set(seen) != all_ids:
        raise AssertionError(f"Iterable shar split missed cuts: {sorted(all_ids - set(seen))[:5]}")
    dupes = {k: v for k, v in seen.items() if v != 1}
    if dupes:
        raise AssertionError(f"Iterable shar split duplicated cuts: {dupes}")


def _equal_on_every_rank(t: torch.Tensor) -> bool:
    gathered = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, t)
    return all(torch.equal(t, g) for g in gathered)


def _dryrun_rank(rank: int, n_devices: int) -> None:
    from lhotse_tpu_torch.models.encoder import draw_mask
    from lhotse_tpu_torch.ops.augment import make_augment_fbank_pipeline
    from lhotse_tpu_torch.ops.resample import resampled_num_samples
    from lhotse_tpu_torch.ops.wire import encode_wire

    torch.set_num_threads(1)  # n ranks share the host's cores
    mesh = _mesh(n_devices)
    dp, data_rank = mesh.size(0), mesh.get_local_rank("data")
    mine = slice(data_rank * DRYRUN_BATCH_PER_RANK, (data_rank + 1) * DRYRUN_BATCH_PER_RANK)

    # 1a) The iterable-style data contract (Shar shards), once.
    if rank == 0:
        _check_iterable_shar_coverage(world_size=max(dp, 2), num_workers=2)

    # 1b) Map-style: each data rank's sampler partition with real fbank
    # features, padded to a common (T, 80) into the global batch.
    rank_batches = _rank_batches_real_features(dp, DRYRUN_BATCH_PER_RANK)
    T = max(fb.shape[1] for fb, _, _ in rank_batches)
    feats = torch.from_numpy(np.concatenate(
        [np.pad(fb, ((0, 0), (0, T - fb.shape[1]), (0, 0))) for fb, _, _ in rank_batches]
    ).astype(np.float32))
    feat_lens = torch.from_numpy(np.concatenate([ln for _, ln, _ in rank_batches]).astype(np.int64))

    # 1c) The on-device input chain on this data rank's rows of an int16
    # wire batch: speed perturb -> gain -> SNR mix -> RIR reverb -> fbank.
    sr, b_aud = 16000, dp * DRYRUN_BATCH_PER_RANK
    rng = np.random.RandomState(0)
    rir = np.exp(-np.arange(sr // 8) / 300.0).astype(np.float32)
    rir[3] = 1.0
    chain = make_augment_fbank_pipeline(
        sampling_rate=sr, speed_factor=1.1, wire_format="int16", rir=rir, device="cpu")
    wire = encode_wire((rng.randn(b_aud, DRYRUN_AUDIO_SAMPLES) * 0.1).astype(np.float32), "int16")
    lens = np.full(b_aud, DRYRUN_AUDIO_SAMPLES, np.int64)
    gains = rng.uniform(0.9, 1.1, b_aud).astype(np.float32)
    noise_len = resampled_num_samples(DRYRUN_AUDIO_SAMPLES, round(sr * 1.1), sr)
    noise = (rng.randn(b_aud, noise_len) * 0.05).astype(np.float32)
    snr = rng.uniform(10, 20, b_aud).astype(np.float32)
    aud_feats, _ = chain(wire[mine], lens[mine], gains=gains[mine], noise=noise[mine],
                         snr=snr[mine], mix_mask=np.ones(DRYRUN_BATCH_PER_RANK, np.float32))
    if aud_feats.shape[0] != DRYRUN_BATCH_PER_RANK or not torch.isfinite(aud_feats).all():
        raise AssertionError(f"data rank {data_rank}: the device chain gave "
                             f"{tuple(aud_feats.shape)} or non-finite features")

    # 2-3) Parameters tensor-parallel, the batch data-parallel: one SGD step.
    mask = draw_mask(feat_lens, T, DRYRUN_CONFIG.mask_prob, torch.Generator().manual_seed(1))
    loss, params = _sharded_sgd_step(
        Encoder(DRYRUN_CONFIG, device="cpu"), mesh, feats, feat_lens, mask)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"Non-finite loss in the multi-rank dry-run: {loss}")
    if not _equal_on_every_rank(loss.reshape(1).float()):
        raise AssertionError("the ranks' losses differ")
    flat = torch.cat([p.reshape(-1).float() for p in params.values()])
    if not _equal_on_every_rank(flat):
        raise AssertionError("the ranks' updated parameters differ")


def dryrun_multichip(n_devices: int) -> None:
    """
    Run one sharded training step over an ``n_devices`` mesh of CPU ranks:
    the Shar (rank × worker) coverage check, each data rank's sampler
    partition with real fbank features and the augment→fbank chain on its
    rows of a wire batch, the encoder's parameters placed by
    ``param_shardings`` over ("data", "model") (two model ranks when
    ``n_devices`` is even), each data rank's rows of the global feature
    batch, and one ``sgd_train_step`` (``DRYRUN_CONFIG``) whose loss and
    updated parameters must be finite and the same on every rank. Raises if
    any rank fails.
    """
    run_gloo_ranks(_dryrun_rank, n_devices)
