"""
Smoke run of the PyTorch port on one CUDA card: builds the fbank kernel
and the host C libraries (FLAC, the ``dsp`` wire encoders, the LTC1 feature
codec) from this checkout, holds the kernel against its plain PyTorch
version, drives the on-device augment→fbank path through
``OnDeviceAugmenter`` at the 15 s × 256 bucket with the int16 and the
adpcm4 wire (the C encoder's bytes against the numpy encoder's), through
the device sample cache over two epochs fed by ``transfer_stream``, and
through the ``Fbank`` and ``Mfcc`` extractors on the card; then the model
path (int16 audio → the augmenter → ``Encoder(EncoderConfig())`` in bf16:
a forward at 15 s × 64, 20 AdamW steps and one SGD step at 15 s × 32, both
batches' features held against the chain with the kernel's plain version),
the ``entry()`` fbank→encoder entry (its fbank layer against the plain
version, its output against the CPU port), WPE of a 2-channel 10 s signal
against the CPU port, the host data path into the trainer step (a
160-recording FLAC corpus through ``CutSet.from_jsonl_lazy``,
``DynamicBucketingSampler``, ``K2SpeechRecognitionDataset`` and
``DataLoader`` into the augmenter and an AdamW step of
``Encoder(EncoderConfig())``, with a mid-epoch resume, and the same over
the device sample cache), and the precomputed-features path on the same
corpus (``compute_and_store_features_batch`` on the kernel into a
``lilcom_chunky`` archive, that archive through
``K2SpeechRecognitionDataset()`` into the AdamW step, and
``OnTheFlyFeatures`` on the kernel into the step); then the augmented
training path (the corpus speed-perturbed and mixed with a 4 x 10 s FLAC
noise pool through ``OnTheFlyFeatures`` on the kernel into the AdamW step
for two epochs, and ``CutMix`` on the stored features, the noise pool's
features extracted on the kernel into the same archive); then the Shar
corpus path (phase 11's manifest exported to Shar shards with their
``.idx`` files; the streaming reader split across the two worker processes
of a ``torch.utils.data.DataLoader`` through ``IterableDatasetWrapper``,
the kernel on each batch in this process, into the AdamW step for two
epochs; the indexed reader, shuffled, through ``OnTheFlyFeatures`` on the
kernel, with a mid-epoch resume through the seek backend; the stored
features from the shards into the step); and checks what comes out.

    python3 chip_smoke.py

It needs a CUDA card and the checkout beside it; without either it exits
non-zero and prints no result. It imports neither ``jax`` nor
``lhotse_tpu``. Every check raises on failure, so a zero exit means every
phase passed. The line before the last is a JSON record of the kernel
(launches on the main path, max-abs error against the plain version, per
call times by CUDA events and device times by ``torch.profiler`` for the
kernel and its plain version at each shape, its bound at each shape (the
mel product counted over each filter's nonzero bins, as the kernel runs it), the
near-silent check against float64, and ``launches_by_path``: the kernel's
launches on each path, ``augment_int16``, ``augment_adpcm4``, ``cached``,
``extractor_fbank``, ``extractor_mfcc``, ``model``, ``entry``, ``e2e``,
``e2e_cached``, ``precomputed_extract``, ``precomputed_train`` (0: it
reads stored features), ``on_the_fly``, ``augmented_on_the_fly``,
``precomputed_mix_extract``, ``precomputed_mix`` (0: it mixes stored
features), ``shar_on_the_fly``, ``shar_indexed`` and ``shar_precomputed``
(0: it reads stored features)); the last line is
``{"ok": true, "device": {...}}``. The corpus, the archive and the
libraries' builds go under ``build/`` in the checkout.
"""
import json
import math
import queue
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SR = 16000
SPEED = 1.1
KERNEL_TOL = 5e-5  # the JAX package's own bound for the fused fbank (tests/test_fbank_pallas.py)
CHAIN_TOL = 1e-4  # the feature parity budget (BASELINE.md)
CACHE_TOL = 1e-5  # cached vs wire features (tests/test_device_cache.py's bound)
TIMING_RUNS = 10
BUCKET = (15.0, 256)
# The encoder's bf16 hidden states against the CPU port, as the CPU tests
# hold the port to JAX (tests/test_torch_entry.py); float32 at 1e-4.
ENTRY_BF16_TOL = 5e-2
ENTRY_F32_TOL = 1e-4
# WPE on the card against the CPU port, at tests/test_torch_wpe.py's bounds
# against the JAX function.
WPE_CORR, WPE_REL = 0.99, 0.1
# The card's peaks (H100 SXM data sheet, dense): float32 outside the tensor
# cores, and HBM.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _device_ms(fn, kernel: str = "") -> float:
    """Device time per call of ``fn`` from ``torch.profiler`` over
    ``TIMING_RUNS`` calls after one warm-up: the sum of the device
    activities whose name contains ``kernel`` (all of them when empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMING_RUNS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name)
    if not us > 0:
        raise AssertionError(f"torch.profiler recorded no device time for {kernel or 'the call'}")
    return us / 1000.0 / TIMING_RUNS


def _device_busy(fn):
    """Run ``fn`` once under ``torch.profiler``. Returns its host-clock wall
    ms, the ms in which the device was busy (the union of the intervals of
    its device activities: kernels, copies, sets) and the device ms by
    activity name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, reach = 0.0, -math.inf
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    if not busy_us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    return wall_ms, busy_us / 1e3, by_name


def _near_silent_errors(device, ops, fbank_cuda) -> tuple:
    """Max-abs error from float64 of the kernel and of its plain version on
    a 3 x 1001-frame 1 kHz tone at 0.3 over 1e-3 white noise, whose low mel
    bins nearly cancel; the truth is the same frames through float64
    matrices on the card."""
    B, T = 3, 1001
    N = (T - 1) * 160 + 400
    t = np.arange(N) / SR
    x_np = 0.3 * np.sin(2 * np.pi * 1000.0 * t) + 1e-3 * np.random.default_rng(9).standard_normal((B, N))
    x = torch.from_numpy(x_np.astype(np.float32)).to(device)
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    f32 = [torch.from_numpy(np.ascontiguousarray(m)).to(device)
           for m in fbank_cuda._squeeze_nyquist(Mc, Ms, _mel_bank(80, ops))]
    f64 = [m.double() for m in f32]
    frames = x.double().unfold(-1, 400, 160)
    power = (frames @ f64[0]) ** 2 + (frames @ f64[1]) ** 2
    truth = torch.log(torch.clamp_min(power @ f64[2], ops.FLT_EPS))
    kernel = fbank_cuda.fbank_cuda(x, *f32).double()
    plain = fbank_cuda.reference_fbank(x, *f32).double()
    return (kernel - truth).abs().max().item(), (plain - truth).abs().max().item()


def _median_ms(fn) -> float:
    """Median of ``TIMING_RUNS`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _mel_bank(n_mels: int, ops) -> np.ndarray:
    mel, _ = ops.get_mel_banks(n_mels, 512, SR, 20.0, -400.0)
    fb = np.zeros((257, n_mels), np.float32)
    fb[:256] = mel.T
    return fb


def _mel_macs(fb: torch.Tensor) -> int:
    """Multiply-adds per frame of the mel product as the kernel does it: each
    filter over the bins from its first to its last nonzero weight."""
    nz = fb != 0
    bins = torch.arange(fb.shape[0], device=fb.device)[:, None]
    first = torch.where(nz, bins, fb.shape[0]).amin(0)
    last = torch.where(nz, bins, -1).amax(0)
    return int((last - first + 1).clamp_min(0).sum())


def _expected_feat_lens(lens: np.ndarray) -> np.ndarray:
    """ceil(lens · 16000 / 17600) samples after speed 1.1, then the hop rule."""
    return (-(-lens * 10 // 11) + 80) // 160


def _check_chain(staged, feats, feat_lens, wire_format, rir, device, fbank_cuda,
                 path: str = "") -> float:
    """Max-abs of the path's features against the same chain with the
    kernel's plain version on the card (these plain runs launch no kernel);
    raises past ``CHAIN_TOL`` or on other ``feat_lens``."""
    path = path or f"{wire_format} path"
    from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank
    from lhotse_tpu_torch.ops.augment import make_augment_fbank_pipeline

    plain_pipe = make_augment_fbank_pipeline(
        sampling_rate=SR, speed_factor=SPEED, wire_format=wire_format, rir=rir, device=device,
        fbank=_PlainFbank(Wav2LogFilterBank(device=device), fbank_cuda))
    plain_feats, plain_lens = plain_pipe(staged.audio, staged.lens, **staged.kwargs)
    err = (plain_feats - feats).abs().max().item()
    print(f"{path} vs the same chain with the plain fbank: max_abs_err {err!r} (tol {CHAIN_TOL})")
    if not err <= CHAIN_TOL or not torch.equal(plain_lens, feat_lens):
        raise AssertionError(f"the {path} disagrees with the plain chain")
    return err


def _phase_adpcm4(common, batch, rir, device, fbank_cuda, smi: str) -> int:
    """4. The adpcm4 wire at the full bucket: the stage's encode (the C
    encoder) against the numpy encoder byte for byte, the card's decode of
    the staged batch against the numpy decode bit for bit, the features
    against the plain chain. Returns the kernel's launches on the path."""
    from lhotse_tpu_torch.dataset import device_augment
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.ops import wire

    aug = OnDeviceAugmenter(buckets=[BUCKET], wire_format="adpcm4", **common)
    audio, lens = batch
    encoded = []

    def timed_encode(x, wire_format):  # the stage's own encode, timed
        t = time.perf_counter()
        out = wire.encode_wire(x, wire_format)
        encoded.append((time.perf_counter() - t, x, out))
        return out

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    device_augment.encode_wire = timed_encode
    try:
        staged = aug.stage(audio, lens)
    finally:
        device_augment.encode_wire = wire.encode_wire
    stage_ms = (time.perf_counter() - t0) * 1e3
    feats, feat_lens = aug.compute(staged)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    elapsed = time.perf_counter() - t0
    encode_s, encode_in, encode_out = encoded[0]
    t = time.perf_counter()
    numpy_out = wire._adpcm4_encode_np(encode_in)
    numpy_ms = (time.perf_counter() - t) * 1e3
    if not np.array_equal(encode_out, numpy_out):
        raise AssertionError("the C adpcm4 encoder's bytes differ from the numpy encoder's")
    decoded = wire.decode_wire(staged.audio, "adpcm4")
    if not torch.equal(decoded.cpu(), torch.from_numpy(wire.adpcm4_decode_np(staged.audio.cpu().numpy()))):
        raise AssertionError("the card's adpcm4 decode differs from adpcm4_decode_np")
    decode_ms = _device_ms(lambda: wire.decode_wire(staged.audio, "adpcm4"))
    width = tuple(staged.audio.shape)
    print(f"[{smi}] adpcm4 {BUCKET[0]:g} s x {BUCKET[1]}: wire {width} uint8 ({wire.wire_bytes_per_sample('adpcm4')} B/sample); "
          f"host encode {encode_s * 1e3!r} ms (C encoder; bytes equal to the numpy encoder's, which "
          f"took {numpy_ms!r} ms), stage {stage_ms!r} ms; decode on the card "
          f"bit-exact, device {decode_ms!r} ms per batch (torch.profiler); "
          f"{float(lens.sum()) / SR / elapsed!r} audio-s/s (stage + compute); "
          f"fbank kernel launches {launches}")
    frames = (math.ceil(int(BUCKET[0] * SR) * 10 / 11) + 80) // 160
    if tuple(feats.shape) != (BUCKET[1], frames, 80) or not torch.isfinite(feats).all():
        raise AssertionError(f"adpcm4 features {tuple(feats.shape)} wrong or not finite")
    if not np.array_equal(feat_lens.cpu().numpy(), _expected_feat_lens(lens)):
        raise AssertionError("adpcm4 feat_lens differ from the hop rule")
    _check_chain(staged, feats, feat_lens, "adpcm4", common["rir"], device, fbank_cuda)
    return launches


def _produce(stage, epoch_batches, ids_of, placeholder: bool):
    """A producer thread that stages the epoch's batches with
    ``transfer=False`` (an epoch of a fully cached corpus stages from
    ``(B, 0)`` placeholders, as a cache-aware input strategy gives them), and
    a generator over what it staged. The generator re-raises the thread's
    error and joins it."""
    out = queue.Queue(maxsize=2)

    def run():
        try:
            for i, (audio, lens) in enumerate(epoch_batches):
                if placeholder:
                    audio = np.zeros((audio.shape[0], 0), np.float32)
                out.put(stage(audio, lens, ids=ids_of(i), transfer=False))
        except Exception as e:  # handed to the consumer, which raises it
            out.put(e)
        out.put(None)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def items():
        try:
            while (item := out.get()) is not None:
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            thread.join(timeout=60)
            if thread.is_alive():
                raise AssertionError("the producer thread did not stop")

    return items()


def _phase_cache(common, cache_batches, device, fbank_cuda) -> int:
    """5. The sample cache over two epochs, fed through ``transfer_stream``
    by a producer thread, and a third (cached) epoch under ``torch.profiler``
    for the device's busy share. Returns the kernel's launches in the cached
    epoch."""
    from lhotse_tpu_torch.dataset.device_augment import CachedBatch, OnDeviceAugmenter, StagedBatch
    from lhotse_tpu_torch.dataset.device_cache import DeviceSampleCache
    from lhotse_tpu_torch.dataset.loader import transfer_stream

    n, (sec, bsz) = len(cache_batches), BUCKET
    cache = DeviceSampleCache(capacity_seconds=n * bsz * sec)
    aug = OnDeviceAugmenter(buckets=[BUCKET], wire_format="int16", sample_cache=cache, **common)

    def ids_of(i):
        return [f"b{i}_{k}" for k in range(bsz)]

    def run_epoch(placeholder):
        staged, outs = [], []
        for s in transfer_stream(_produce(aug.stage, cache_batches, ids_of, placeholder),
                                 lookahead=2, device=device):
            staged.append(s)
            outs.append(aug.compute(s))
        return staged, outs

    audio_sec = sum(float(lens.sum()) for _, lens in cache_batches) / SR
    epochs, launches = [], 0
    for epoch in range(2):
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        staged, outs = run_epoch(epoch == 1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = fbank_cuda.LAUNCHES
        if epoch == 0 and not all(isinstance(s, StagedBatch) and s.insert_slots is not None
                                  for s in staged):
            raise AssertionError("epoch 1 of the cache phase was not all misses with inserts")
        if epoch == 1 and not all(isinstance(s, CachedBatch) for s in staged):
            raise AssertionError("epoch 2 of the cache phase was not all cached")
        epochs.append((staged, outs))
        print(f"sample cache epoch {epoch + 1}: {n} batches of {sec:g} s x {bsz}, {audio_sec!r} audio-s in "
              f"{elapsed!r} s: {audio_sec / elapsed!r} audio-s/s; fbank kernel launches {launches}")
    if launches < n:
        raise AssertionError(f"the cached epoch launched the fbank kernel {launches} times")
    stats = cache.stats()
    print(f"sample cache: hit rate {stats['hit_rate']!r}, {stats['resident_items']} items resident, "
          f"memory_bytes {stats['memory_bytes']}")
    wall_ms, busy_ms, by_name = _device_busy(lambda: run_epoch(True))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"sample cache epoch 3 (cached, under torch.profiler): wall {wall_ms!r} ms, device busy "
          f"{busy_ms!r} ms ({busy_ms / n!r} ms per batch, {busy_ms / wall_ms!r} of the wall); "
          f"device ms by activity: " + "; ".join(f"{k[:60]} {v!r}" for k, v in top))

    # Epoch 2 against a cache-less augmenter with the same seed, at the
    # counters epoch 2 was staged with.
    cached, cached_outs = epochs[1]
    ref = OnDeviceAugmenter(buckets=[BUCKET], wire_format="int16", **common)
    ref.load_state_dict({"seed": 0, "next_counter": cached[0].aug_counter})
    err = 0.0
    for (audio, lens), (feats, feat_lens) in zip(cache_batches, cached_outs):
        ref_feats, ref_lens = ref(audio, lens)
        if not torch.equal(ref_lens, feat_lens):
            raise AssertionError("cached feat_lens differ from the cache-less augmenter's")
        real = feat_lens > 0
        err = max(err, (feats[real] - ref_feats[real]).abs().max().item())
    grouped = aug.compute_grouped(cached[:2])
    group_equal = all(torch.equal(g, o[0]) for (g, _), o in zip(grouped, cached_outs))
    print(f"cached epoch vs the cache-less augmenter: max_abs_err {err!r} (tol {CACHE_TOL}); "
          f"compute_grouped of 2 cached batches equal to compute: {group_equal}")
    if not err <= CACHE_TOL or not group_equal:
        raise AssertionError("the cached path disagrees with the wire path")
    if aug.state_dict(after=cached[0])["next_counter"] != cached[0].aug_counter + 1:
        raise AssertionError("state_dict(after=cached_batch) is not its counter + 1")
    return launches


def _phase_extractors(device, fbank_cuda, ops) -> dict:
    """6. ``Fbank`` and ``Mfcc`` extraction on the card against the same
    extractors on the CPU (the port's plain route). Returns the kernel's
    launches per extractor."""
    from lhotse_tpu_torch.features.kaldi import extractors

    rng = np.random.default_rng(6)
    items = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in rng.integers(1 * SR, 20 * SR + 1, size=8)]
    audio_sec = sum(len(x) for x in items) / SR
    launches = {}
    for kind in ("Fbank", "Mfcc"):
        cls, cfg_cls = getattr(extractors, kind), getattr(extractors, f"{kind}Config")
        on_card = cls(cfg_cls(device=device))
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        feats = on_card.extract_batch(items, SR)
        first_s = time.perf_counter() - t0
        launches[f"extractor_{kind.lower()}"] = fbank_cuda.LAUNCHES
        t0 = time.perf_counter()
        on_card.extract_batch(items, SR)
        warm_s = time.perf_counter() - t0
        ref = cls(cfg_cls(device="cpu")).extract_batch(items, SR)
        err = max(float(np.abs(a - b).max()) for a, b in zip(feats, ref))
        snip = cls(cfg_cls(device=device, snip_edges=True)).extract_batch(items, SR)
        want = [ops.compute_num_frames_pad(len(x), 160) for x in items]
        want_snip = [ops.compute_num_frames_snip(len(x), 400, 160) for x in items]
        print(f"{kind} extractor on the card, 8 items of 1-20 s: max_abs_err vs the CPU route "
              f"{err!r} (tol {CHAIN_TOL}); {audio_sec / first_s!r} audio-s/s first call, "
              f"{audio_sec / warm_s!r} audio-s/s second call; fbank kernel launches "
              f"{launches[f'extractor_{kind.lower()}']}")
        if [f.shape[0] for f in feats] != want or [f.shape[0] for f in snip] != want_snip:
            raise AssertionError(f"{kind} frame counts differ from _num_frames")
        if not err <= CHAIN_TOL or not all(np.isfinite(f).all() for f in feats):
            raise AssertionError(f"{kind} on the card disagrees with the CPU route")
    return launches


def _int16_batch(rng, bsz: int, sec: int):
    """A (bsz, sec) batch of 0.1-scale noise with lengths from half of sec to sec."""
    lens = rng.integers(sec * SR // 2, sec * SR + 1, size=bsz)
    lens[0] = sec * SR
    return rng.standard_normal((bsz, sec * SR), np.float32) * 0.1, lens


def _phase_model(common, rng, device, fbank_cuda, sec: int = 15, train_b: int = 32,
                 fwd_b: int = 64) -> int:
    """7. The model path at full width: int16 batches through the augmenter
    (the fbank kernel) into ``Encoder(EncoderConfig())`` in bf16; a forward
    at 15 s x 64 with no grad, then 20 AdamW steps and one SGD step at
    15 s x 32. Both batches' features are then held against the plain chain.
    Returns the kernel's launches on the path."""
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.models import encoder as enc_mod

    cfg = enc_mod.EncoderConfig()
    aug32 = OnDeviceAugmenter(buckets=[(sec, train_b)], wire_format="int16", **common)
    aug64 = OnDeviceAugmenter(buckets=[(sec, fwd_b)], wire_format="int16", **common)
    batch32, batch64 = _int16_batch(rng, train_b, sec), _int16_batch(rng, fwd_b, sec)
    model = enc_mod.Encoder(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    frames = (math.ceil(sec * SR * 10 / 11) + 80) // 160

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    staged64 = aug64.stage(*batch64)
    feats64, lens64 = aug64.compute(staged64)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        hidden = model(feats64, lens64)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated()
    staged32 = aug32.stage(*batch32)
    feats, feat_lens = aug32.compute(staged32)
    init, adamw_step = enc_mod.make_adamw_train_step(lr=1e-3)
    opt = init(model)

    def masks(n):
        return [enc_mod.draw_mask(feat_lens, frames, cfg.mask_prob, gen) for _ in range(n)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(adamw_step(model, opt, feats, feat_lens, m)) for m in masks(15)]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 15
    step_masks = masks(5)
    _, busy_ms, by_name = _device_busy(
        lambda: losses.extend(float(adamw_step(model, opt, feats, feat_lens, m)) for m in step_masks))
    train_peak = torch.cuda.max_memory_allocated()
    sgd_loss = float(enc_mod.sgd_train_step(model, feats, feat_lens, masks(1)[0], lr=1e-3))
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES

    with torch.no_grad():
        fwd_ms = _device_ms(lambda: model(feats64, lens64))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"model path: features {tuple(feats64.shape)} -> hidden {tuple(hidden.shape)} {hidden.dtype}; "
          f"forward at {sec} s x {fwd_b} {fwd_ms!r} ms device (torch.profiler), peak memory "
          f"{fwd_peak!r} B; AdamW at {sec} s x {train_b}: losses {losses[0]!r} -> {losses[-1]!r} over "
          f"{len(losses)} steps, {busy_ms / 5!r} ms device per step (torch.profiler, 5 steps), "
          f"{wall_ms!r} ms wall per step (15 steps), peak memory {train_peak!r} B; SGD loss "
          f"{sgd_loss!r}; fbank kernel launches {launches}")
    print("model step device ms by activity (5 steps): "
          + "; ".join(f"{k[:60]} {v!r}" for k, v in top))
    for t, b in ((feats64, fwd_b), (feats, train_b)):
        if tuple(t.shape) != (b, frames, 80) or not torch.isfinite(t).all():
            raise AssertionError(f"model-path features {tuple(t.shape)} wrong or not finite")
    for staged, f, n, b in ((staged64, feats64, lens64, fwd_b), (staged32, feats, feat_lens, train_b)):
        _check_chain(staged, f, n, "int16", common["rir"], device, fbank_cuda,
                     path=f"model path's {sec} s x {b} features")
    if tuple(hidden.shape) != (fwd_b, frames, cfg.d_model) or not torch.isfinite(hidden).all():
        raise AssertionError(f"hidden states {tuple(hidden.shape)} wrong or not finite")
    if not all(math.isfinite(x) for x in losses + [sgd_loss]) or not losses[-1] < losses[0]:
        raise AssertionError(f"the AdamW loss did not fall or is not finite: {losses}, {sgd_loss}")
    return launches


def _phase_entry(device, fbank_cuda) -> int:
    """8. ``entry()`` on the card: its fbank layer (the kernel) against the
    kernel's plain version on the entry's audio; then the whole entry
    against the same entry on the CPU port, bf16 at the entry's
    configuration, and a float32 encoder at a small size on the same
    features. Returns the kernel's launches on the path."""
    from lhotse_tpu_torch import entry as entry_mod
    from lhotse_tpu_torch.models.encoder import Encoder, EncoderConfig

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    fn, (audio, audio_lens, encoder, fbank) = entry_mod.entry(device)
    with torch.no_grad():
        hidden, feat_lens = fn(audio, audio_lens, encoder, fbank)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    with torch.no_grad():
        feats = fbank(audio)
        fbank_err = (feats - _PlainFbank(fbank, fbank_cuda)(audio)).abs().max().item()
    cpu_fn, cpu_args = entry_mod.entry("cpu")
    with torch.no_grad():
        cpu_hidden, cpu_lens = cpu_fn(*cpu_args)
        # float32 at a small size, on the card's features on both sides: the
        # encoder alone (the features differ by the kernel's ~1e-5).
        cfg = EncoderConfig(num_layers=2, d_model=64, num_heads=4, ffn_dim=128, dtype=torch.float32)
        f32 = Encoder(cfg, device=device)(feats, feat_lens).cpu()
        f32_cpu = Encoder(cfg, device="cpu")(feats.cpu(), cpu_lens)
    bf16_err = (hidden.float().cpu() - cpu_hidden.float()).abs().max().item()
    f32_err = (f32 - f32_cpu).abs().max().item()
    print(f"entry: fbank layer {tuple(feats.shape)} vs the kernel's plain version max_abs_err "
          f"{fbank_err!r} (tol {KERNEL_TOL}); hidden {tuple(hidden.shape)} {hidden.dtype}, feat_lens "
          f"{feat_lens.tolist()}; card vs CPU port max_abs_err bf16 {bf16_err!r} (tol "
          f"{ENTRY_BF16_TOL}), float32 {f32_err!r} (tol {ENTRY_F32_TOL}); fbank kernel launches "
          f"{launches}")
    if not fbank_err <= KERNEL_TOL:
        raise AssertionError(f"the entry's fbank disagrees with the plain version: {fbank_err}")
    if tuple(hidden.shape) != (4, 400, 128) or not torch.isfinite(hidden).all():
        raise AssertionError(f"entry output {tuple(hidden.shape)} wrong or not finite")
    if not torch.equal(feat_lens.cpu(), cpu_lens) or feat_lens.tolist() != [400, 398, 400, 200]:
        raise AssertionError(f"entry feat_lens {feat_lens.tolist()} differ")
    if not bf16_err <= ENTRY_BF16_TOL or not f32_err <= ENTRY_F32_TOL:
        raise AssertionError("the card's entry disagrees with the CPU port's")
    return launches


def _reverberant(channels: int, seconds: float, seed: int) -> np.ndarray:
    """tests/test_ops_wpe.py's signal: three harmonics of 150 Hz, amplitude-
    modulated at 3 Hz, through a decaying random RIR per channel."""
    rng = np.random.RandomState(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    dry = sum(np.sin(2 * np.pi * 150 * (h + 1) * t) / (h + 1) for h in range(3))
    dry = (0.2 * dry * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    out = []
    for _ in range(channels):
        rir = np.exp(-np.arange(2000) / 300.0) * rng.randn(2000) * 0.3
        rir[0] = 1.0
        out.append(np.convolve(dry, rir)[:n])
    return np.stack(out).astype(np.float32)


def _phase_wpe(device) -> None:
    """9. WPE of a 2-channel 10 s reverberant signal on the card against
    the CPU port."""
    from lhotse_tpu_torch.ops.wpe import dereverb_wpe

    audio = _reverberant(channels=2, seconds=10.0, seed=0)
    x = torch.from_numpy(audio).to(device)
    out = dereverb_wpe(x).cpu().numpy()
    ref = dereverb_wpe(audio, device="cpu").numpy()
    corr = float(np.corrcoef(out.ravel(), ref.ravel())[0, 1])
    rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    e_ratio = float(np.sum(out ** 2) / np.sum(audio ** 2))
    ms = _device_ms(lambda: dereverb_wpe(x))
    print(f"WPE 2 x 10 s on the card: {ms!r} ms device (torch.profiler); vs the CPU port "
          f"correlation {corr!r} (> {WPE_CORR}), relative error {rel!r} (< {WPE_REL}); output "
          f"energy / input energy {e_ratio!r}")
    if out.shape != audio.shape or not np.isfinite(out).all():
        raise AssertionError("WPE output wrong or not finite")
    if not corr > WPE_CORR or not rel < WPE_REL or not e_ratio < 1.0:
        raise AssertionError("WPE on the card disagrees with the CPU port")


# -- 10. the host data path into the trainer step -------------------------------
# bench.py:528 (the e2e legs' shape vocabulary) and bench.py::_synthesize_corpus.
E2E_BUCKETS = [(6.0, 41), (9.0, 28), (12.0, 21), (14.0, 19)]
E2E_RECORDINGS = 160
E2E_SECONDS = (4.0, 14.0)  # the corpus's uniform duration range


def _synthesize_corpus(root: Path, n_recordings: int, n_noise: int = 4) -> tuple:
    """``bench.py::_synthesize_corpus`` with the port: FLAC tone bursts of
    uniform 4-14 s at 16 kHz (numpy seed 1234), one supervision each, then a
    pool of ``n_noise`` 10 s bursts drawn after them from the same generator,
    written with ``write_flac`` and ``CutSet.to_file``. Returns the paths of
    the two manifests."""
    from lhotse_tpu_torch.audio import Recording
    from lhotse_tpu_torch.audio.flacio import write_flac
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.supervision import SupervisionSegment

    rng = np.random.RandomState(1234)

    def tone_burst(duration):
        n = int(SR * duration)
        t = np.arange(n) / SR
        f0 = rng.uniform(80, 220)
        wave = sum(np.sin(2 * np.pi * f0 * (h + 1) * t) / (h + 1) for h in range(4)) * 0.2
        wave += rng.randn(n) * 0.01
        return wave.astype(np.float32)

    cuts = []
    for i in range(n_recordings):
        duration = float(rng.uniform(*E2E_SECONDS))
        path = root / f"utt{i:04d}.flac"
        write_flac(str(path), tone_burst(duration), SR)
        cut = Recording.from_file(path).to_cut()
        cut.supervisions.append(SupervisionSegment(
            id=f"sup{i:04d}", recording_id=cut.recording_id, start=0.0, duration=cut.duration,
            text="synthetic"))
        cuts.append(cut)
    path = root / "cuts.jsonl"
    CutSet.from_cuts(cuts).to_file(path)
    noise = []
    for i in range(n_noise):
        write_flac(str(root / f"noise{i:02d}.flac"), tone_burst(10.0), SR)
        noise.append(Recording.from_file(root / f"noise{i:02d}.flac").to_cut())
    noise_path = root / "noise.jsonl"
    CutSet.from_cuts(noise).to_file(noise_path)
    return path, noise_path


def _e2e_augmenter(device, sample_cache=None):
    """The augmenter of ``bench.py::bench_e2e_tpu`` (bench.py:531-559) on
    ``device``, and its RIR."""
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment

    rng_init = np.random.RandomState(99)
    L = SR // 2
    rir = (np.exp(-np.arange(L) / (L / 6.0)) * rng_init.randn(L) * 0.5).astype(np.float32)
    rir[L // 50] = 1.0
    noise = (rng_init.randn(4, 10 * SR) * 0.05).astype(np.float32)
    aug = OnDeviceAugmenter(
        E2E_BUCKETS, sampling_rate=SR, speed_factor=SPEED, gain_range=(0.8, 1.2),
        noise_pool=noise, snr=(10, 20), mix_prob=1.0, rir=rir, wire_format="int16", seed=0,
        specaugment=SpecAugment(seed=0), sample_cache=sample_cache, device=device)
    return aug, rir


def _e2e_loader(cuts_path: Path, aug, device, cached: bool = False):
    """The sampler, dataset and loader of ``bench.py:568-600``: lazy cuts,
    ``FixedBucketBatchSizeConstraint`` over the bucket vocabulary, shuffled
    with seed 0, ``K2SpeechRecognitionDataset`` with ``AudioSamples`` (with
    ``CacheAwareAudioSamples`` when ``cached``), the augmenter's
    ``stage(..., transfer=False)`` in the main thread and the copy to the
    card two batches ahead. Each item is ``(staged, cut ids, lens,
    placeholder)``."""
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.device_cache import CacheAwareAudioSamples, batch_cut_info
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
        DynamicBucketingSampler, FixedBucketBatchSizeConstraint)
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.tracing import trace_span

    sampler = DynamicBucketingSampler(
        CutSet.from_jsonl_lazy(cuts_path),
        constraint=FixedBucketBatchSizeConstraint(
            max_seq_len_buckets=[ub for ub, _ in E2E_BUCKETS],
            batch_sizes=[bsz for _, bsz in E2E_BUCKETS]),
        num_buckets=None, duration_bins=[ub for ub, _ in E2E_BUCKETS[:-1]],
        buffer_size=max(E2E_RECORDINGS, 16), shuffle=True, seed=0, world_size=1, rank=0)
    strategy = CacheAwareAudioSamples(aug) if cached else AudioSamples()
    dataset = K2SpeechRecognitionDataset(return_cuts=True, input_strategy=strategy)

    def stage(batch):
        ids, lens = batch_cut_info(batch)
        with trace_span("augmenter.stage"):
            staged = aug.stage(batch["inputs"], lens, ids=ids if cached else None, transfer=False)
        return staged, ids, lens, batch["inputs"].shape[1] == 0

    loader = DataLoader(sampler, dataset, prefetch_batches=3, main_apply_fn=stage,
                        transfer_lookahead=2, checkpoint_objects=[aug], device=device)
    return loader, sampler


class _Trainer:
    """One AdamW step of ``Encoder(EncoderConfig())`` per batch of
    features, with masks from a seeded generator on the card."""

    def __init__(self, device):
        from lhotse_tpu_torch.models import encoder as enc_mod

        self.enc = enc_mod
        self.cfg = enc_mod.EncoderConfig()
        self.model = enc_mod.Encoder(self.cfg, device=device)
        init, self.adamw_step = enc_mod.make_adamw_train_step(lr=1e-3)
        self.opt = init(self.model)
        self.gen = torch.Generator(device=device).manual_seed(10)

    def step(self, feats, feat_lens) -> float:
        mask = self.enc.draw_mask(feat_lens, feats.shape[1], self.cfg.mask_prob, self.gen)
        return float(self.adamw_step(self.model, self.opt, feats, feat_lens, mask))


def _run_epoch(loader, aug, trainer, on_batch=None) -> dict:
    """Consume one epoch of ``loader``: features on the card (the fbank
    kernel), then the trainer's step. ``on_batch(i, item, feats,
    feat_lens)`` sees each batch before its step."""
    items, losses, wait_s, audio_s = [], [], 0.0, 0.0
    it = iter(loader)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            break
        wait_s += time.perf_counter() - t
        staged, ids, lens, placeholder = item
        feats, feat_lens = aug.compute(staged)
        if on_batch is not None:
            on_batch(len(items), item, feats, feat_lens)
        losses.append(trainer.step(feats, feat_lens))
        items.append((type(staged).__name__, list(ids), np.asarray(lens), placeholder,
                      getattr(staged, "insert_slots", None) is not None))
        audio_s += float(np.sum(lens)) / SR
    torch.cuda.synchronize()
    return {"items": items, "losses": losses, "wait_s": wait_s, "audio_s": audio_s,
            "elapsed_s": time.perf_counter() - t0}


def _host_split(report: dict, n: int, wait_s: float) -> str:
    def ms(span):
        return report.get(span, {}).get("total_s", 0.0) * 1e3 / n

    return (f"host ms per batch: decode+collate (dataset.assemble, loader thread) "
            f"{ms('dataset.assemble')!r} (of which audio.decode {ms('audio.decode')!r}), "
            f"stage {ms('augmenter.stage')!r}, consumer's wait in next() (stage and the copy "
            f"included) {wait_s * 1e3 / n!r}")


def _phase_e2e(cuts_path: Path, device, fbank_cuda, smi: str) -> dict:
    """10. The host data path into the trainer step, as a trainer runs it:
    a FLAC corpus read back lazily into ``DynamicBucketingSampler`` →
    ``K2SpeechRecognitionDataset`` → ``DataLoader`` (staging and the copy
    two batches ahead) → the augmenter (the fbank kernel) → an AdamW step of
    ``Encoder(EncoderConfig())``. Path ``e2e``: one timed epoch (cut
    coverage, bucket sizes, the first batch against the plain chain, a
    falling loss, one launch per batch), a second under ``torch.profiler``
    for the busy share, and a mid-epoch resume from ``loader.state_dict()``
    after batch 3 into a fresh sampler, augmenter and loader. Path
    ``e2e_cached``: the same loader over a ``DeviceSampleCache`` with
    ``CacheAwareAudioSamples``, two epochs, the second all hits. Returns
    the kernel's launches per path."""
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.device_cache import DeviceSampleCache
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report

    set_caching_enabled(True)  # the decoded-audio LRU, as bench.py's e2e legs
    set_tracing_enabled(True)
    all_cuts = list(CutSet.from_jsonl_lazy(cuts_path))
    trainer = _Trainer(device)

    # -- e2e: the timed epoch ----------------------------------------------
    aug, rir = _e2e_augmenter(device)
    loader, sampler = _e2e_loader(cuts_path, aug, device)
    kept = {}

    def keep(i, item, feats, feat_lens):
        staged = item[0]
        if i == 0:
            kept["first"] = (staged, feats.clone(), feat_lens.clone())
        if i == 2:  # three batches consumed
            kept["ckpt"] = loader.state_dict()
        if i in (3, 4):
            kept[i] = (item[1], staged.audio.cpu().numpy(),
                       {k: v.cpu().numpy() for k, v in staged.kwargs.items()}, feats.clone())

    reset_tracing()
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    run = _run_epoch(loader, aug, trainer, on_batch=keep)
    launches = fbank_cuda.LAUNCHES
    n = len(run["items"])
    split = _host_split(tracing_report(), n, run["wait_s"])
    ids = [i for _, batch_ids, *_ in run["items"] for i in batch_ids]
    print(f"[{smi}] e2e epoch: {n} batches, {run['audio_s']!r} audio-s in {run['elapsed_s']!r} s "
          f"(host clock, AdamW steps included): {run['audio_s'] / run['elapsed_s']!r} audio-s/s; "
          f"losses {run['losses'][0]!r} -> {run['losses'][-1]!r}; fbank kernel launches {launches}")
    print(f"[{smi}] e2e {split}")
    if sorted(ids) != sorted(c.id for c in all_cuts):
        raise AssertionError("the e2e epoch did not bring every cut exactly once")
    for _, batch_ids, lens, _, _ in run["items"]:
        ub, size = next((ub, size) for ub, size in E2E_BUCKETS if lens.max() <= ub * SR)
        if len(batch_ids) > size:
            raise AssertionError(f"a {ub:g} s batch of {len(batch_ids)} exceeds its size {size}")
    if launches != n:
        raise AssertionError(f"the e2e path launched the fbank kernel {launches} times for {n} batches")
    losses = run["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the e2e loss did not fall or is not finite: {losses}")
    staged0, feats0, lens0 = kept["first"]
    _check_chain(staged0, feats0, lens0, "int16", rir, device, fbank_cuda,
                 path="e2e first batch")

    # -- e2e: a second epoch under torch.profiler ------------------------------
    sampler.set_epoch(1)
    wall_ms, busy_ms, by_name = _device_busy(lambda: _run_epoch(loader, aug, trainer))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[{smi}] e2e epoch 2 under torch.profiler: wall {wall_ms!r} ms, device busy "
          f"{busy_ms!r} ms ({busy_ms / wall_ms!r} of the wall); device ms by activity: "
          + "; ".join(f"{k[:60]} {v!r}" for k, v in top))

    # -- e2e: mid-epoch resume into a fresh sampler, augmenter and loader ------
    aug2, _ = _e2e_augmenter(device)
    loader2, _ = _e2e_loader(cuts_path, aug2, device)
    loader2.load_state_dict(kept["ckpt"])
    it2 = iter(loader2)
    for i in (3, 4):
        staged, batch_ids, _, _ = next(it2)
        feats, _ = aug2.compute(staged)
        want_ids, want_audio, want_draws, want_feats = kept[i]
        same = (batch_ids == want_ids and np.array_equal(staged.audio.cpu().numpy(), want_audio)
                and set(staged.kwargs) == set(want_draws)
                and all(np.array_equal(v.cpu().numpy(), want_draws[k])
                        for k, v in staged.kwargs.items())
                and torch.equal(feats, want_feats))
        if not same:
            raise AssertionError(f"batch {i + 1} after the resume differs from the first run")
    it2.close()
    print(f"e2e mid-epoch resume from loader.state_dict() after batch 3: batches 4 and 5 "
          f"equal (cut ids, wire audio, draws, torch.equal features)")

    # -- e2e_cached: two epochs over the device sample cache -------------------
    cache = DeviceSampleCache(capacity_seconds=2 * 3600)
    aug_c, _ = _e2e_augmenter(device, sample_cache=cache)
    loader_c, sampler_c = _e2e_loader(cuts_path, aug_c, device, cached=True)
    cached_out = []

    def keep_cached(i, item, feats, feat_lens):
        cached_out.append((item[0].aug_counter, list(item[1]), feats.clone()))

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    epochs = []
    for epoch in range(2):
        sampler_c.set_epoch(epoch)
        cached_out.clear()
        reset_tracing()
        epochs.append(_run_epoch(loader_c, aug_c, trainer, on_batch=keep_cached))
        report = tracing_report()
        r = epochs[-1]
        print(f"[{smi}] e2e_cached epoch {epoch + 1}: {len(r['items'])} batches, "
              f"{r['audio_s']!r} audio-s in {r['elapsed_s']!r} s: "
              f"{r['audio_s'] / r['elapsed_s']!r} audio-s/s (AdamW steps included); "
              f"{_host_split(report, len(r['items']), r['wait_s'])}")
    launches_cached = fbank_cuda.LAUNCHES
    first, second = epochs
    if not all(kind == "StagedBatch" and inserted and not ph
               for kind, _, _, ph, inserted in first["items"]):
        raise AssertionError("e2e_cached epoch 1 was not all misses with inserts")
    if not all(kind == "CachedBatch" and ph for kind, _, _, ph, _ in second["items"]):
        raise AssertionError("e2e_cached epoch 2 was not all hits with (B, 0) placeholders")
    if tracing_report().get("audio.decode", {}).get("calls", 0):
        raise AssertionError("e2e_cached epoch 2 decoded audio on the host")
    n_cached = len(first["items"]) + len(second["items"])
    if launches_cached != n_cached:
        raise AssertionError(
            f"e2e_cached launched the fbank kernel {launches_cached} times for {n_cached} batches")
    # Epoch 2 against a cache-less augmenter on the decoded audio, at the
    # counters epoch 2 was staged with.
    ref, _ = _e2e_augmenter(device)
    ref.load_state_dict({"seed": 0, "next_counter": cached_out[0][0]})
    by_id = {c.id: c for c in all_cuts}
    err = 0.0
    for _, batch_ids, feats in cached_out:
        audio, lens = AudioSamples()(CutSet.from_cuts([by_id[i] for i in batch_ids]))
        ref_feats, ref_lens = ref(audio, lens)
        real = ref_lens > 0
        err = max(err, (feats[real] - ref_feats[real]).abs().max().item())
    print(f"e2e_cached epoch 2 vs the wire path: max_abs_err {err!r} (tol {CACHE_TOL}); "
          f"hit rate {cache.stats()['hit_rate']!r}, memory_bytes {cache.memory_bytes()}; "
          f"fbank kernel launches {launches_cached}")
    if not err <= CACHE_TOL:
        raise AssertionError("e2e_cached epoch 2 disagrees with the wire path")
    set_tracing_enabled(False)
    set_caching_enabled(False)
    return {"e2e": launches, "e2e_cached": launches_cached}


# -- 11. the precomputed-features path -------------------------------------------
LTC1_TICK = 2.0**-5  # the chunky archive's quantum at tick_power=-5
LOG_EPSILON = math.log(1e-10)  # the feature-domain padding of the collators


def _plain_extract(extractor, items) -> list:
    """``extractor.extract_batch(items)`` with the kernel's plain version on
    the card in place of the kernel: the same prepared, zero-padded batch,
    the same squeezed matrices, each item sliced to its frame count."""
    from lhotse_tpu_torch.ops import fbank_cuda

    device = extractor.device
    prepared = [extractor._prepare_item(np.asarray(x, np.float32)) for x in items]
    batch = np.zeros((len(prepared), max(len(p) for p in prepared)), np.float32)
    for i, p in enumerate(prepared):
        batch[i, : len(p)] = p
    Mc, Ms, fb, _ = extractor._layer()._fused_matrices()
    mats = fbank_cuda._squeeze_nyquist(*(fbank_cuda._as_f32(m, device) for m in (Mc, Ms, fb)))
    out = fbank_cuda.reference_fbank(torch.from_numpy(batch).to(device), *mats).cpu().numpy()
    return [out[i, : extractor._num_frames(len(x))] for i, x in enumerate(items)]


class _RecordFirstBatch:
    """Wraps ``extractor.extract_batch`` to keep the first call's items and
    features."""

    def __init__(self, extractor):
        self.first = None
        inner = extractor.extract_batch

        def extract_batch(items, sampling_rate, **kw):
            out = inner(items, sampling_rate, **kw)
            if self.first is None:
                self.first = ([np.asarray(x).copy() for x in items], [np.asarray(f).copy() for f in out])
            return out

        extractor.extract_batch = extract_batch


def _sampler_over(cuts):
    """Phase 10's ``DynamicBucketingSampler`` (buckets, constraint, shuffle
    with seed 0) over another manifest of the same cuts, or a lazy CutSet."""
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (
        DynamicBucketingSampler, FixedBucketBatchSizeConstraint)

    return DynamicBucketingSampler(
        cuts if isinstance(cuts, CutSet) else CutSet.from_jsonl_lazy(cuts),
        constraint=FixedBucketBatchSizeConstraint(
            max_seq_len_buckets=[ub for ub, _ in E2E_BUCKETS],
            batch_sizes=[bsz for _, bsz in E2E_BUCKETS]),
        num_buckets=None, duration_bins=[ub for ub, _ in E2E_BUCKETS[:-1]],
        buffer_size=max(E2E_RECORDINGS, 16), shuffle=True, seed=0, world_size=1, rank=0)


def _train_epoch(loader, trainer, device, on_batch=None) -> dict:
    """One epoch of ``K2SpeechRecognitionDataset`` batches of features (one
    supervision per cut) into the trainer's AdamW step on ``device``."""
    ids, losses, wait_s, audio_s = [], [], 0.0, 0.0
    it = iter(loader)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        wait_s += time.perf_counter() - t
        cuts = batch["supervisions"]["cut"]
        feats = torch.from_numpy(batch["inputs"]).to(device)
        feat_lens = torch.from_numpy(
            np.asarray(batch["supervisions"]["num_frames"], np.int64)).to(device)
        if on_batch is not None:
            on_batch(len(losses), cuts, batch)
        losses.append(trainer.step(feats, feat_lens))
        ids.extend(c.id for c in cuts)
        audio_s += sum(c.duration for c in cuts)
    torch.cuda.synchronize()
    return {"ids": ids, "losses": losses, "wait_s": wait_s, "audio_s": audio_s,
            "elapsed_s": time.perf_counter() - t0}


def _check_epoch(name: str, run: dict, all_ids: list) -> None:
    if sorted(run["ids"]) != sorted(all_ids):
        raise AssertionError(f"the {name} epoch did not bring every cut exactly once")
    losses = run["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the {name} loss did not fall or is not finite: {losses}")


def _phase_precomputed(cuts_path: Path, workdir: Path, device, fbank_cuda, smi: str) -> tuple:
    """11. The precomputed-features path at full width, on phase 10's FLAC
    corpus. ``precomputed_extract``: ``CutSet.compute_and_store_features_batch``
    with ``Fbank(device="cuda")`` into the default ``lilcom_chunky`` archive
    (first batch against the kernel's plain version, the archive against the
    kernel's output, a second decode equal to the first).
    ``precomputed_train``: the written manifest through phase 10's sampler,
    ``K2SpeechRecognitionDataset()`` (its default ``PrecomputedFeatures``)
    and ``DataLoader(prefetch_batches=3)`` into an AdamW step of
    ``Encoder(EncoderConfig())`` per batch (no kernel launch), a second epoch
    under ``torch.profiler``. ``on_the_fly``: the FLAC manifest through the
    same sampler with ``OnTheFlyFeatures(Fbank(device="cuda"))`` into the
    same step (one launch per batch; the first batch against the plain
    version, the CPU route and the precomputed batch of the same cuts).
    Returns the kernel's launches per path and the largest kernel-vs-plain
    error."""
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures, PrecomputedFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report

    set_caching_enabled(False)  # every read decodes its bytes anew
    all_ids = [c.id for c in CutSet.from_jsonl_lazy(cuts_path)]

    # -- precomputed_extract ------------------------------------------------------
    extractor = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(extractor)
    feats_cuts = workdir / "feats_cuts.jsonl"
    set_tracing_enabled(True)
    reset_tracing()
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    stored = CutSet.from_jsonl_lazy(cuts_path).compute_and_store_features_batch(
        extractor, workdir / "feats", manifest_path=feats_cuts, batch_duration=600,
        num_workers=4)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches_extract = fbank_cuda.LAUNCHES
    report = tracing_report()
    read_extract_s = report.get("CutSet.compute_and_store_features_batch", {}).get("total_s", 0.0)
    decode_s = report.get("audio.decode", {}).get("total_s", 0.0)
    stored = {c.id: c for c in stored}
    audio_s = sum(c.duration for c in stored.values())
    archive = workdir / "feats.lca"
    f32_bytes = sum(4 * c.features.num_frames * c.features.num_features for c in stored.values())
    items, kernel_out = recorder.first
    plain = _plain_extract(extractor, items)
    extract_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, plain))
    first_ids = [i for i in all_ids if i in stored][: len(items)]
    archive_err, redecode_equal = 0.0, True
    for cid, k in zip(first_ids, kernel_out):
        got = stored[cid].load_features()
        archive_err = max(archive_err, float(np.abs(got - k).max()))
        redecode_equal &= np.array_equal(got, stored[cid].load_features())
    print(f"[{smi}] precomputed_extract: {len(stored)} cuts, {audio_s!r} audio-s extracted and "
          f"stored in {extract_s!r} s: {audio_s / extract_s!r} audio-s/s (host clock, FLAC decode, "
          f"kernel, LTC1 encode and the archive write included); fbank kernel launches "
          f"{launches_extract}; archive {archive.stat().st_size} B, "
          f"{archive.stat().st_size / f32_bytes!r} of float32 ({f32_bytes} B); of the wall, "
          f"read + extract {read_extract_s!r} s (FLAC decode {decode_s!r} s summed over the 4 "
          f"read threads), the rest the writer thread's LTC1 encode and write")
    print(f"precomputed_extract first batch ({len(items)} cuts): kernel vs its plain version "
          f"max_abs_err {extract_err!r} (tol {KERNEL_TOL}); archive vs the kernel's output "
          f"{archive_err!r} (tol {LTC1_TICK / 2 + 1e-6!r}); a second decode equal: {redecode_equal}")
    if sorted(stored) != sorted(all_ids):
        raise AssertionError("precomputed_extract did not store every cut")
    if launches_extract < 1 or not extract_err <= KERNEL_TOL:
        raise AssertionError("precomputed_extract: the kernel did not run or disagrees with plain")
    if not archive_err <= LTC1_TICK / 2 + 1e-6 or not redecode_equal:
        raise AssertionError("the archive's features disagree with the kernel's output")

    # -- precomputed_train ---------------------------------------------------------
    trainer = _Trainer(device)
    dataset = K2SpeechRecognitionDataset(return_cuts=True)
    if not isinstance(dataset.input_strategy, PrecomputedFeatures):
        raise AssertionError("K2SpeechRecognitionDataset() does not default to PrecomputedFeatures")
    sampler = _sampler_over(feats_cuts)
    loader = DataLoader(sampler, dataset, prefetch_batches=3)
    first_pre = {}

    def keep_pre(i, cuts, batch):
        if i == 0:
            first_pre["ids"] = [c.id for c in cuts]

    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device, on_batch=keep_pre)
    launches_train = fbank_cuda.LAUNCHES
    n = len(run["losses"])
    read_ms = tracing_report().get("dataset.assemble", {}).get("total_s", 0.0) * 1e3 / n
    sampler.set_epoch(1)
    wall_ms, busy_ms, by_name = _device_busy(lambda: _train_epoch(loader, trainer, device))
    print(f"[{smi}] precomputed_train epoch: {n} batches, {run['audio_s']!r} audio-s in "
          f"{run['elapsed_s']!r} s (host clock, AdamW steps included): "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; losses {run['losses'][0]!r} -> "
          f"{run['losses'][-1]!r}; host ms per batch of the feature read (dataset.assemble, "
          f"loader thread) {read_ms!r}, consumer's wait in next() {run['wait_s'] * 1e3 / n!r}; "
          f"epoch 2 under torch.profiler: wall {wall_ms!r} ms, device busy {busy_ms!r} ms "
          f"({busy_ms / wall_ms!r} of the wall); fbank kernel launches {launches_train}")
    _check_epoch("precomputed_train", run, all_ids)
    if launches_train != 0:
        raise AssertionError(f"precomputed_train launched the fbank kernel {launches_train} times")

    # -- on_the_fly -----------------------------------------------------------------
    fly_extractor = Fbank(FbankConfig(device=device))
    fly_recorder = _RecordFirstBatch(fly_extractor)
    loader = DataLoader(_sampler_over(cuts_path), K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(fly_extractor)), prefetch_batches=3)
    first_fly = {}

    def keep_fly(i, cuts, batch):
        if i == 0:
            first_fly["cuts"] = CutSet.from_cuts(cuts)
            first_fly["inputs"] = batch["inputs"]

    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device, on_batch=keep_fly)
    launches_fly = fbank_cuda.LAUNCHES
    n = len(run["losses"])
    assemble_ms = tracing_report().get("dataset.assemble", {}).get("total_s", 0.0) * 1e3 / n
    set_tracing_enabled(False)
    items, kernel_out = fly_recorder.first
    plain_out = _plain_extract(fly_extractor, items)
    fly_plain_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, plain_out))
    # The CPU route takes its DFT products in float64. Where a tone's
    # leakage nearly cancels in the lowest mel bins, every float32 route is
    # ~2e-4 from it; the kernel must lose no more than its plain version.
    cpu_feats, _ = OnTheFlyFeatures(Fbank(FbankConfig(device="cpu")))(first_fly["cuts"])
    cpu_err = float(np.abs(first_fly["inputs"] - cpu_feats).max())
    plain_batch = np.full_like(first_fly["inputs"], LOG_EPSILON)
    for i, f in enumerate(plain_out):
        plain_batch[i, : len(f)] = f
    plain_cpu_err = float(np.abs(plain_batch - cpu_feats).max())
    pre_feats, _ = PrecomputedFeatures()(CutSet.from_cuts(
        [stored[c.id] for c in first_fly["cuts"]]))
    pre_err = float(np.abs(first_fly["inputs"] - pre_feats).max())
    print(f"[{smi}] on_the_fly epoch: {n} batches, {run['audio_s']!r} audio-s in "
          f"{run['elapsed_s']!r} s (host clock, AdamW steps included): "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; losses {run['losses'][0]!r} -> "
          f"{run['losses'][-1]!r}; host ms per batch of decode+extract+collate "
          f"(dataset.assemble) {assemble_ms!r}; fbank kernel launches {launches_fly}")
    print(f"on_the_fly first batch: kernel vs its plain version {fly_plain_err!r} (tol {KERNEL_TOL}); "
          f"vs the CPU route (float64 DFT products) {cpu_err!r}, where the plain version is "
          f"{plain_cpu_err!r} (tol: {KERNEL_TOL} or twice the plain version's); vs the "
          f"precomputed batch of the same "
          f"cuts {pre_err!r} (tol {LTC1_TICK / 2 + KERNEL_TOL!r})")
    _check_epoch("on_the_fly", run, all_ids)
    if launches_fly != n:
        raise AssertionError(f"on_the_fly launched the fbank kernel {launches_fly} times for {n} batches")
    if not fly_plain_err <= KERNEL_TOL or not cpu_err <= max(KERNEL_TOL, 2 * plain_cpu_err):
        raise AssertionError("on_the_fly features disagree with the plain version or the CPU route")
    if not pre_err <= LTC1_TICK / 2 + KERNEL_TOL:
        raise AssertionError("on_the_fly features disagree with the precomputed batch")
    launches = {"precomputed_extract": launches_extract, "precomputed_train": launches_train,
                "on_the_fly": launches_fly}
    return launches, max(extract_err, fly_plain_err)


# -- 12. the augmented training path ----------------------------------------------
MIXED_SHARE = (0.35, 0.65)  # mix_prob 0.5 over 160 cuts


def _span_ms(report: dict, n: int) -> str:
    return ", ".join(
        f"{span} {report.get(span, {}).get('total_s', 0.0) * 1e3 / n!r}"
        for span in ("audio.decode", "audio.transforms", "dataset.assemble"))


def _augmented_epochs(loader, sampler, trainer, device, on_batch) -> tuple:
    """Two epochs: the first timed on the host clock with tracing, the
    second under ``torch.profiler`` for the device's busy share."""
    from lhotse_tpu_torch.tracing import reset_tracing, tracing_report

    reset_tracing()
    run = _train_epoch(loader, trainer, device, on_batch=lambda i, c, b: on_batch(0, i, c, b))
    report = tracing_report()
    sampler.set_epoch(1)
    second = {}

    def epoch2():
        second.update(_train_epoch(loader, trainer, device,
                                   on_batch=lambda i, c, b: on_batch(1, i, c, b)))

    wall_ms, busy_ms, _ = _device_busy(epoch2)
    return run, second, report, busy_ms / wall_ms


def _phase_augmented(cuts_path: Path, noise_path: Path, feats_cuts: Path, workdir: Path, device,
                     fbank_cuda, smi: str) -> tuple:
    """12. The augmented training path at full width, on phase 10's corpus
    and its noise pool. ``augmented_on_the_fly``: the shape of
    ``bench.py::bench_host_pipeline`` (bench.py:309-340),
    ``CutSet.from_jsonl_lazy(cuts).perturb_speed(1.1).mix(noise, snr=(10, 20),
    mix_prob=0.5, seed=7)`` with the decoded-audio LRU on → phase 10's
    sampler → ``K2SpeechRecognitionDataset`` with
    ``OnTheFlyFeatures(Fbank(device="cuda"))`` → ``DataLoader`` → an AdamW
    step per batch, two epochs (every perturbed cut once per epoch, a mixed
    share near one half, one launch per batch, the first batch against the
    kernel's plain version on the same mixed audio, a falling loss).
    ``precomputed_mix_extract``: the noise pool's features extracted on the
    kernel into phase 11's archive. ``precomputed_mix``: phase 11's stored
    manifest through ``CutMix(noise with features, p=0.5, snr=(10, 20),
    preserve_id=True, seed=7)`` and ``PrecomputedFeatures`` into the step,
    two epochs (no launch; mixed features never below the lead track's
    stored features by more than half a tick). Returns the kernel's launches
    per path and the largest kernel-vs-plain error."""
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet, MixedCut
    from lhotse_tpu_torch.dataset.cut_transforms import CutMix
    from lhotse_tpu_torch.dataset.input_strategies import OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report

    sup_ids = sorted(f"{s.id}_sp1.1" for c in CutSet.from_jsonl_lazy(cuts_path) for s in c.supervisions)
    n_cuts = len(sup_ids)

    # -- augmented_on_the_fly ------------------------------------------------------
    set_caching_enabled(True)  # bench.py's setting: the noise pool is re-read per mixed cut
    augmented = CutSet.from_jsonl_lazy(cuts_path).perturb_speed(1.1).mix(
        CutSet.from_file(noise_path), snr=(10, 20), mix_prob=0.5, seed=7)
    extractor = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(extractor)
    sampler = _sampler_over(augmented)
    loader = DataLoader(sampler, K2SpeechRecognitionDataset(
        return_cuts=True, input_strategy=OnTheFlyFeatures(extractor)), prefetch_batches=3)
    seen = ([], [])
    mixed = [0, 0]

    def count(epoch, i, cuts, batch):
        seen[epoch].extend(s.id for c in cuts for s in c.supervisions)
        mixed[epoch] += sum(isinstance(c, MixedCut) for c in cuts)

    trainer = _Trainer(device)
    set_tracing_enabled(True)
    fbank_cuda.LAUNCHES = 0
    run, run2, report, busy = _augmented_epochs(loader, sampler, trainer, device, count)
    launches_aug = fbank_cuda.LAUNCHES
    set_caching_enabled(False)
    n = len(run["losses"])
    n_batches = n + len(run2["losses"])
    items, kernel_out = recorder.first
    plain_out = _plain_extract(extractor, items)
    aug_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, plain_out))
    losses = run["losses"] + run2["losses"]
    share = [m / n_cuts for m in mixed]
    print(f"[{smi}] augmented_on_the_fly epoch 1: {n} batches, {run['audio_s']!r} audio-s in "
          f"{run['elapsed_s']!r} s (host clock, AdamW steps included): "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; host ms per batch (loader thread) "
          f"{_span_ms(report, n)}; epoch 2 under torch.profiler: {run2['audio_s'] / run2['elapsed_s']!r} "
          f"audio-s/s, device busy {busy!r} of the wall; mixed share {share[0]!r} / {share[1]!r}; "
          f"fbank kernel launches {launches_aug} for {n_batches} batches; losses {losses[0]!r} -> "
          f"{losses[-1]!r}")
    print(f"augmented_on_the_fly first batch ({len(items)} cuts of mixed audio): kernel vs its "
          f"plain version max_abs_err {aug_err!r} (tol {KERNEL_TOL})")
    for epoch in (0, 1):
        if sorted(seen[epoch]) != sup_ids:
            raise AssertionError(f"augmented epoch {epoch + 1} did not bring every perturbed cut once")
        if not MIXED_SHARE[0] <= share[epoch] <= MIXED_SHARE[1]:
            raise AssertionError(f"augmented epoch {epoch + 1}: mixed share {share[epoch]} off {MIXED_SHARE}")
    if launches_aug != n_batches:
        raise AssertionError(f"augmented_on_the_fly launched {launches_aug} times for {n_batches} batches")
    if not aug_err <= KERNEL_TOL:
        raise AssertionError("augmented_on_the_fly: the kernel disagrees with its plain version")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the augmented loss did not fall or is not finite: {losses}")

    # -- precomputed_mix_extract ----------------------------------------------------
    noise_feats_path = workdir / "noise_feats.jsonl"
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    noise_feats = CutSet.from_file(noise_path).compute_and_store_features_batch(
        Fbank(FbankConfig(device=device)), workdir / "feats", manifest_path=noise_feats_path,
        batch_duration=600, num_workers=4)
    torch.cuda.synchronize()
    launches_noise = fbank_cuda.LAUNCHES
    noise_feats = noise_feats.to_eager()
    print(f"precomputed_mix_extract: {len(noise_feats)} noise cuts stored into the archive; "
          f"fbank kernel launches {launches_noise}")
    if len(noise_feats) != 4 or launches_noise < 1:
        raise AssertionError("precomputed_mix_extract did not store the noise pool on the kernel")

    # -- precomputed_mix --------------------------------------------------------------
    cut_mix = CutMix(noise_feats, p=0.5, snr=(10, 20), preserve_id=True, seed=7)
    sampler = _sampler_over(feats_cuts)
    loader = DataLoader(sampler, K2SpeechRecognitionDataset(
        return_cuts=True, cut_transforms=[cut_mix]), prefetch_batches=3)
    all_ids = sorted(c.id for c in CutSet.from_jsonl_lazy(feats_cuts))
    # CutMix pads each mixed cut to the batch's longest: rates count the corpus's audio.
    corpus_s = sum(c.duration for c in CutSet.from_jsonl_lazy(feats_cuts))
    ids, pmixed, below = ([], []), [0, 0], []

    def check(epoch, i, cuts, batch):
        ids[epoch].extend(c.id for c in cuts)
        pmixed[epoch] += sum(isinstance(c, MixedCut) for c in cuts)
        if epoch == 0 and i == 0:
            for row, cut in enumerate(cuts):
                if isinstance(cut, MixedCut):
                    lead = cut.tracks[0].cut.load_features()
                    below.append(float(np.max(lead - batch["inputs"][row, : len(lead)])))

    trainer = _Trainer(device)
    fbank_cuda.LAUNCHES = 0
    run, run2, report, busy = _augmented_epochs(loader, sampler, trainer, device, check)
    launches_mix = fbank_cuda.LAUNCHES
    set_tracing_enabled(False)
    n = len(run["losses"])
    losses = run["losses"] + run2["losses"]
    share = [m / len(all_ids) for m in pmixed]
    worst_below = max(below) if below else float("nan")
    print(f"[{smi}] precomputed_mix epoch 1: {n} batches, {corpus_s!r} audio-s of the corpus "
          f"({run['audio_s']!r} after CutMix's padding) in {run['elapsed_s']!r} s (host clock, AdamW "
          f"steps included): {corpus_s / run['elapsed_s']!r} audio-s/s; host ms per batch (loader "
          f"thread) {_span_ms(report, n)}; epoch 2 under torch.profiler: {corpus_s / run2['elapsed_s']!r} "
          f"audio-s/s, device busy {busy!r} of the wall; mixed share {share[0]!r} / {share[1]!r}; "
          f"fbank kernel launches {launches_mix}; losses {losses[0]!r} -> {losses[-1]!r}")
    print(f"precomputed_mix first batch: {len(below)} mixed cuts, the lead track's stored features "
          f"above the mix by at most {worst_below!r} (tol {LTC1_TICK / 2!r})")
    for epoch in (0, 1):
        if sorted(ids[epoch]) != all_ids:
            raise AssertionError(f"precomputed_mix epoch {epoch + 1} did not bring every cut once")
        if not MIXED_SHARE[0] <= share[epoch] <= MIXED_SHARE[1]:
            raise AssertionError(f"precomputed_mix epoch {epoch + 1}: mixed share {share[epoch]}")
    if not below or not worst_below <= LTC1_TICK / 2:
        raise AssertionError("precomputed_mix: a mix fell below its lead track's features")
    if launches_mix != 0:
        raise AssertionError(f"precomputed_mix launched the fbank kernel {launches_mix} times")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the precomputed_mix loss did not fall or is not finite: {losses}")
    launches = {"augmented_on_the_fly": launches_aug, "precomputed_mix_extract": launches_noise,
                "precomputed_mix": launches_mix}
    return launches, aug_err


# -- 13. the Shar corpus path ---------------------------------------------------------
SHAR_SHARD_SIZE = 20  # 160 cuts -> 8 shards


def _shar_bytes(out: Path) -> dict:
    """Bytes on disk per Shar field (``cuts``, ``recording``, ``features``)
    and of the ``.idx`` sidecars."""
    sizes = {}
    for p in out.iterdir():
        key = "idx" if p.suffix == ".idx" else p.name.split(".")[0]
        sizes[key] = sizes.get(key, 0) + p.stat().st_size
    return sizes


def _pad_feats(feats: list, device):
    """A list of (frames, mels) arrays -> the (B, T, mels) batch padded with
    ``LOG_EPSILON`` and the frame counts, on ``device``."""
    lens = np.array([len(f) for f in feats], np.int64)
    batch = np.full((len(feats), int(lens.max()), feats[0].shape[1]), LOG_EPSILON, np.float32)
    for i, f in enumerate(feats):
        batch[i, : len(f)] = f
    return torch.from_numpy(batch).to(device), torch.from_numpy(lens).to(device)


def _streaming_epoch(loader, extractor, trainer, device) -> dict:
    """One epoch of ``torch.utils.data.DataLoader`` batches of audio from
    the workers: the fbank kernel on each in this process, the padded
    features into the trainer's step. Returns the cut ids, each cut's shard
    and worker, the losses and the host-clock times."""
    ids, shard_workers, losses, wait_s, audio_s = [], {}, [], 0.0, 0.0
    it = iter(loader)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        wait_s += time.perf_counter() - t
        cuts = batch["supervisions"]["cut"]
        items = [batch["inputs"][i, : c.num_samples] for i, c in enumerate(cuts)]
        feats, feat_lens = _pad_feats(extractor.extract_batch(items, SR), device)
        losses.append(trainer.step(feats, feat_lens))
        for c in cuts:
            ids.append(c.id)
            shard_workers.setdefault(str(c.shard_origin), set()).add(c.dataloading_info["worker_id"])
        audio_s += sum(c.duration for c in cuts)
    torch.cuda.synchronize()
    return {"ids": ids, "shard_workers": shard_workers, "losses": losses, "wait_s": wait_s,
            "audio_s": audio_s, "elapsed_s": time.perf_counter() - t0}


def _phase_shar(cuts_path: Path, feats_cuts: Path, workdir: Path, device, fbank_cuda,
                smi: str) -> tuple:
    """13. The Shar corpus path at full width, on phase 10's corpus and
    phase 11's stored features. ``shar_export``: phase 11's manifest through
    ``to_shar(fields={"recording": "flac", "features": "lilcom"},
    shard_size=20, compress_jsonl=False)`` (8 shards with their ``.idx``
    files; audio read back equal to the FLAC sources, features within one
    LTC1 tick of the archive's). ``shar_on_the_fly``: the cuts and
    recording shards through ``CutSet.from_shar(split_for_dataloading=True,
    shuffle_shards=True, seed=0)`` → phase 10's sampler →
    ``IterableDatasetWrapper(K2SpeechRecognitionDataset(AudioSamples()))`` →
    ``torch.utils.data.DataLoader(batch_size=None, num_workers=2)`` (forked
    workers, host work only), ``Fbank(device="cuda").extract_batch`` on each
    batch in this process and an AdamW step, two epochs (each cut once per
    epoch, each shard read by one worker, both workers used).
    ``shar_indexed``: the indexed shards, shuffled (``LazyIndexedSharIterator``)
    → the sampler → ``OnTheFlyFeatures`` on the card → ``DataLoader`` → the
    step; a checkpoint after batch 3 resumed in a fresh loader through the
    seek backend, equal batches. ``shar_precomputed``: the features shards
    through ``K2SpeechRecognitionDataset()`` into the step, no launch.
    Returns the kernel's launches per path and the largest kernel-vs-plain
    error."""
    from lhotse_tpu_torch.caching import set_caching_enabled
    from lhotse_tpu_torch.cut import CutSet
    from lhotse_tpu_torch.dataset.dataloading import make_worker_init_fn
    from lhotse_tpu_torch.dataset.input_strategies import AudioSamples, OnTheFlyFeatures
    from lhotse_tpu_torch.dataset.iterable_dataset import IterableDatasetWrapper
    from lhotse_tpu_torch.dataset.loader import DataLoader
    from lhotse_tpu_torch.dataset.sampling import checkpoint_backends, dynamic_bucketing
    from lhotse_tpu_torch.dataset.speech_recognition import K2SpeechRecognitionDataset
    from lhotse_tpu_torch.features import Fbank, FbankConfig
    from lhotse_tpu_torch.shar.readers import LazyIndexedSharIterator
    from lhotse_tpu_torch.tracing import reset_tracing, set_tracing_enabled, tracing_report

    set_caching_enabled(False)
    all_ids = sorted(c.id for c in CutSet.from_jsonl_lazy(cuts_path))
    out = workdir / "shar"

    # -- shar_export -----------------------------------------------------------------
    t0 = time.perf_counter()
    paths = CutSet.from_jsonl_lazy(feats_cuts).to_shar(
        out, fields={"recording": "flac", "features": "lilcom"}, shard_size=SHAR_SHARD_SIZE,
        compress_jsonl=False)
    export_s = time.perf_counter() - t0
    sizes = _shar_bytes(out)
    n_idx = len(list(out.glob("*.idx")))
    sources = {c.id: c for c in CutSet.from_jsonl_lazy(feats_cuts)}
    audio_equal, feat_err, feats_identical = True, 0.0, True
    for cut in CutSet.from_shar(in_dir=out):
        src = sources[cut.id]
        audio_equal &= np.array_equal(cut.load_audio(), src.load_audio())
        got, want = cut.load_features(), src.load_features()
        feat_err = max(feat_err, float(np.abs(got - want).max()))
        feats_identical &= np.array_equal(got, want)
    audio_s = sum(c.duration for c in sources.values())
    print(f"[{smi}] shar_export: {len(sources)} cuts, {audio_s!r} audio-s into "
          f"{len(paths['cuts'])} shards in {export_s!r} s: {audio_s / export_s!r} audio-s/s (host "
          f"clock: FLAC and LTC1 decode, FLAC and LTC1 encode, tar writes and indexing); bytes per "
          f"field {sizes}; {n_idx} .idx files; audio read back equal to the FLAC sources: "
          f"{audio_equal}; features vs phase 11's archive max_abs {feat_err!r} (tol {LTC1_TICK!r}), "
          f"identical: {feats_identical}")
    n_shards = math.ceil(len(all_ids) / SHAR_SHARD_SIZE)
    if sorted(sources) != all_ids or len(paths["cuts"]) != n_shards or n_idx != 3 * n_shards:
        raise AssertionError(f"shar_export wrote {len(paths['cuts'])} shards, {n_idx} indexes")
    if not audio_equal or not feat_err <= LTC1_TICK:
        raise AssertionError("shar_export: the shards' data disagree with their sources")

    # -- shar_on_the_fly -----------------------------------------------------------------
    streaming = CutSet.from_shar(
        fields={"cuts": paths["cuts"], "recording": paths["recording"]}, indexed=False,
        split_for_dataloading=True, shuffle_shards=True, seed=0)
    wrapper = IterableDatasetWrapper(
        K2SpeechRecognitionDataset(return_cuts=True, input_strategy=AudioSamples()),
        _sampler_over(streaming))
    loader = torch.utils.data.DataLoader(
        wrapper, batch_size=None, num_workers=2, worker_init_fn=make_worker_init_fn(seed=0),
        multiprocessing_context="fork")
    extractor = Fbank(FbankConfig(device=device))
    recorder = _RecordFirstBatch(extractor)
    trainer = _Trainer(device)
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    wrapper.set_epoch(0)
    run = _streaming_epoch(loader, extractor, trainer, device)
    wrapper.set_epoch(1)
    run2 = {}
    wall_ms, busy_ms, _ = _device_busy(
        lambda: run2.update(_streaming_epoch(loader, extractor, trainer, device)))
    launches_stream = fbank_cuda.LAUNCHES
    n_batches = len(run["losses"]) + len(run2["losses"])
    items, kernel_out = recorder.first
    stream_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, _plain_extract(extractor, items)))
    losses = run["losses"] + run2["losses"]
    print(f"[{smi}] shar_on_the_fly (torch DataLoader, 2 forked workers, the kernel in the main "
          f"process) epoch 1: {len(run['losses'])} batches, {run['audio_s']!r} audio-s in "
          f"{run['elapsed_s']!r} s: {run['audio_s'] / run['elapsed_s']!r} audio-s/s; consumer's "
          f"wait in next() {run['wait_s'] * 1e3 / len(run['losses'])!r} ms per batch (the "
          f"dataset.assemble and audio.decode spans run in the worker processes: not collected); "
          f"epoch 2 under torch.profiler {run2['audio_s'] / run2['elapsed_s']!r} audio-s/s, device "
          f"busy {busy_ms / wall_ms!r} of the wall; fbank kernel launches {launches_stream} for "
          f"{n_batches} batches; losses {losses[0]!r} -> {losses[-1]!r}; first batch kernel vs plain "
          f"{stream_err!r} (tol {KERNEL_TOL})")
    for epoch, r in enumerate((run, run2)):
        if sorted(r["ids"]) != all_ids:
            raise AssertionError(f"shar_on_the_fly epoch {epoch + 1} did not bring every cut once")
        workers = r["shard_workers"]
        if len(workers) != n_shards or any(len(w) != 1 for w in workers.values()) or set().union(
                *workers.values()) != {0, 1}:
            raise AssertionError(f"shar_on_the_fly epoch {epoch + 1}: shards by worker {workers}")
    if launches_stream != n_batches or not stream_err <= KERNEL_TOL:
        raise AssertionError("shar_on_the_fly: launches or the kernel's result are off")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the shar_on_the_fly loss did not fall or is not finite: {losses}")

    # -- shar_indexed --------------------------------------------------------------------
    def indexed_loader():
        cuts = CutSet.from_shar(in_dir=out, shuffle_shards=True, seed=0)
        if not (isinstance(cuts.data, LazyIndexedSharIterator) and cuts.has_constant_time_access):
            raise AssertionError(f"from_shar did not open the indexed reader: {type(cuts.data)}")
        fly = Fbank(FbankConfig(device=device))
        return DataLoader(_sampler_over(cuts), K2SpeechRecognitionDataset(
            return_cuts=True, input_strategy=OnTheFlyFeatures(fly)), prefetch_batches=3), fly

    loader, fly = indexed_loader()
    fly_recorder = _RecordFirstBatch(fly)
    batches, state, losses, ids = [], None, [], []
    set_tracing_enabled(True)
    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        cuts = batch["supervisions"]["cut"]
        feats = torch.from_numpy(batch["inputs"]).to(device)
        feat_lens = torch.from_numpy(np.asarray(batch["supervisions"]["num_frames"], np.int64)).to(device)
        losses.append(trainer.step(feats, feat_lens))
        batches.append(([c.id for c in cuts], batch["inputs"]))
        ids += [c.id for c in cuts]
        if i == 2:
            state = loader.state_dict()
    torch.cuda.synchronize()
    indexed_s = time.perf_counter() - t0
    launches_indexed = fbank_cuda.LAUNCHES
    report = tracing_report()
    set_tracing_enabled(False)
    n = len(batches)
    items, kernel_out = fly_recorder.first
    indexed_err = max(float(np.abs(a - b).max()) for a, b in zip(kernel_out, _plain_extract(fly, items)))
    chosen = []
    real_plan = dynamic_bucketing.plan_resume
    dynamic_bucketing.plan_resume = lambda *a, **k: chosen.append(real_plan(*a, **k)) or chosen[-1]
    try:
        resumed_loader, _ = indexed_loader()
        resumed_loader.load_state_dict(state)
        resumed = []
        fbank_cuda.LAUNCHES = 0
        wall_ms, resumed_busy_ms, _ = _device_busy(lambda: resumed.extend(
            ([c.id for c in b["supervisions"]["cut"]], b["inputs"]) for b in resumed_loader))
        launches_resumed = fbank_cuda.LAUNCHES
    finally:
        dynamic_bucketing.plan_resume = real_plan
    resume_equal = len(resumed) == n - 3 and all(
        a_ids == b_ids and torch.equal(torch.from_numpy(a), torch.from_numpy(b))
        for (a_ids, a), (b_ids, b) in zip(resumed, batches[3:]))
    seek = len(chosen) == 1 and isinstance(chosen[0], checkpoint_backends.SeekResume)
    print(f"[{smi}] shar_indexed (LazyIndexedSharIterator, shuffled; OnTheFlyFeatures on the card): "
          f"{n} batches, {audio_s!r} audio-s in {indexed_s!r} s: {audio_s / indexed_s!r} audio-s/s; "
          f"host ms per batch {_span_ms(report, n)}; fbank kernel launches {launches_indexed}; "
          f"first batch kernel vs plain {indexed_err!r}; resumed after batch 3 through "
          f"{type(chosen[0]).__name__ if chosen else None}: {len(resumed)} batches equal to the "
          f"uninterrupted run's: {resume_equal}, launches {launches_resumed}, device busy "
          f"{resumed_busy_ms / wall_ms!r} of the resumed run's wall (torch.profiler)")
    if sorted(ids) != all_ids or launches_indexed != n or not indexed_err <= KERNEL_TOL:
        raise AssertionError("shar_indexed: coverage, launches or the kernel's result are off")
    if not seek or not resume_equal or launches_resumed != n - 3:
        raise AssertionError(f"shar_indexed resume: seek {seek}, equal {resume_equal}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"the shar_indexed loss is not finite: {losses}")

    # -- shar_precomputed ------------------------------------------------------------------
    stored = CutSet.from_shar(fields={"cuts": paths["cuts"], "features": paths["features"]})
    loader = DataLoader(_sampler_over(stored), K2SpeechRecognitionDataset(return_cuts=True),
                        prefetch_batches=3)
    set_tracing_enabled(True)
    reset_tracing()
    fbank_cuda.LAUNCHES = 0
    run = _train_epoch(loader, trainer, device)
    launches_pre = fbank_cuda.LAUNCHES
    report = tracing_report()
    set_tracing_enabled(False)
    n = len(run["losses"])
    print(f"[{smi}] shar_precomputed (features shards, memory_lilcom): {n} batches, "
          f"{run['audio_s']!r} audio-s in {run['elapsed_s']!r} s: "
          f"{run['audio_s'] / run['elapsed_s']!r} audio-s/s; host ms per batch "
          f"{_span_ms(report, n)}; fbank kernel launches {launches_pre}")
    if sorted(run["ids"]) != all_ids or launches_pre != 0:
        raise AssertionError("shar_precomputed: coverage or launches are off")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError(f"the shar_precomputed loss is not finite: {run['losses']}")
    launches = {"shar_on_the_fly": launches_stream, "shar_indexed": launches_indexed,
                "shar_precomputed": launches_pre}
    return launches, max(stream_err, indexed_err)


class _PlainFbank:
    """The default fbank layer's computation with the kernel's plain version
    in place of the kernel, for the chain comparison."""

    frame_shift = 0.01

    def __init__(self, layer, fbank_cuda):
        self.layer = layer
        self.fbank_cuda = fbank_cuda

    def __call__(self, x):
        Mc, Ms, fb, _ = self.layer._fused_matrices()
        padded = self.fbank_cuda.edge_pad(x)
        return self.fbank_cuda.reference_fbank(padded, Mc, Ms, fb)


def main() -> None:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False.")
    import lhotse_tpu_torch

    if Path(lhotse_tpu_torch.__file__).resolve().parent.parent != ROOT:
        sys.exit(f"lhotse_tpu_torch was imported from {lhotse_tpu_torch.__file__}, not from {ROOT}.")
    from lhotse_tpu_torch import _build
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.dataset.signal_transforms import SpecAugment
    from lhotse_tpu_torch.ops import fbank as ops
    from lhotse_tpu_torch.ops import fbank_cuda

    assert "jax" not in sys.modules and "lhotse_tpu" not in sys.modules
    # The plain versions this script compares against must be IEEE fp32:
    # TF32 keeps ~3 decimal digits. Matmuls default to fp32 already; cuDNN
    # convolutions default to TF32 (the port's resampler turns it off itself).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # -- 1. environment -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    fbank_cuda._lib()
    print(f"fbank kernel built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path('fbank')})")
    # The host C libraries (byte-for-byte copies of the JAX package's
    # sources), built here so that no phase times a build.
    from lhotse_tpu_torch.audio import flacio
    from lhotse_tpu_torch.codecs import lilcom_codec
    from lhotse_tpu_torch.ops import host_dsp

    for name, get_lib in (("flac", flacio._get_lib), ("dsp", host_dsp._get_lib),
                          ("lilcom (LTC1)", lilcom_codec._native_lib)):
        t0 = time.perf_counter()
        get_lib()
        print(f"{name} host library built and loaded in {time.perf_counter() - t0:.2f} s")

    # -- 2. kernel vs plain version -------------------------------------------
    # The kernel gets the packed DFT operand as the layers hold it, so its
    # times are of the launch alone.
    Mc, Ms = ops.dft_analysis_matrices(400, 512)
    cases = []
    # 200 filters run in two of the kernel's 128-filter chunks.
    for B, T, n_mels in [(1, 100, 23), (3, 1001, 80), (3, 1001, 200), (256, 1364, 80)]:
        Mc_d, Ms_d, fb_d = (
            torch.from_numpy(np.ascontiguousarray(m)).to(device)
            for m in fbank_cuda._squeeze_nyquist(Mc, Ms, _mel_bank(n_mels, ops)))
        dft = fbank_cuda.pack_dft(Mc_d, Ms_d)
        N = (T - 1) * 160 + 400
        x = torch.from_numpy(
            np.random.default_rng(B).standard_normal((B, N), np.float32) * 0.1).to(device)

        def kernel():
            return fbank_cuda.fbank_cuda(x, Mc_d, Ms_d, fb_d, dft=dft)

        def plain():
            return fbank_cuda.reference_fbank(x, Mc_d, Ms_d, fb_d)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if out.shape != (B, T, n_mels) or not torch.isfinite(out).all():
            raise AssertionError(f"kernel output {tuple(out.shape)} wrong or not finite")
        case = {"shape": [B, T, n_mels], "max_abs_err": (out - ref).abs().max().item(),
                "ms": _median_ms(kernel), "plain_ms": _median_ms(plain),
                "device_ms": _device_ms(kernel, "fbank_logmel"), "plain_device_ms": _device_ms(plain)}
        # The two DFT products and the mel product over each filter's bins.
        flop = B * T * (400 * 256 * 4 + 2 * _mel_macs(fb_d))
        case["flop"] = flop
        # Each input read once (audio, packed DFT, mel bank), the output written once.
        nbytes = 4 * (B * N + dft.numel() + fb_d.numel() + B * T * n_mels)
        t_ops, t_bytes = flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        case["bound_ms"] = max(t_ops, t_bytes) * 1e3
        case["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        print(f"fbank B={B} T={T} n_mels={n_mels}: max_abs_err {case['max_abs_err']!r} "
              f"(tol {KERNEL_TOL}); per call (CUDA events, median of {TIMING_RUNS}) kernel "
              f"{case['ms']!r} ms, plain {case['plain_ms']!r} ms; device (torch.profiler) "
              f"kernel {case['device_ms']!r} ms ({flop / case['device_ms'] / 1e9:.1f} TFLOP/s), "
              f"plain {case['plain_device_ms']!r} ms; bound {case['bound_ms']!r} ms "
              f"({case['bound_by']})")
        if not case["max_abs_err"] <= KERNEL_TOL:
            raise AssertionError(
                f"kernel disagrees with its plain version: {case['max_abs_err']} > {KERNEL_TOL}")
        cases.append(case)
    main_case = cases[-1]  # the main path's shape

    kernel_err, plain_err = _near_silent_errors(device, ops, fbank_cuda)
    print(f"near-silent 3 x 1001 x 80 against float64: kernel {kernel_err!r}, plain {plain_err!r} "
          f"(the kernel may be at most twice as far off)")
    if not kernel_err <= 2 * plain_err:
        raise AssertionError(f"kernel lost digits on a near-silent input: {kernel_err} > 2 x {plain_err}")

    # -- 3. main path ---------------------------------------------------------
    rng = np.random.default_rng(0)
    noise_pool = rng.standard_normal((16, 16 * SR), np.float32) * 0.1
    t_rir = np.arange(SR // 2, dtype=np.float32)
    rir = (rng.standard_normal(SR // 2).astype(np.float32) * np.exp(-t_rir / 1600.0)).astype(
        np.float32)
    rir[0] = 1.0
    common = dict(speed_factor=SPEED, gain_range=(0.9, 1.1), noise_pool=noise_pool,
                  snr=(10, 20), mix_prob=0.5, rir=rir, specaugment=SpecAugment(seed=0),
                  device=device)
    aug = OnDeviceAugmenter(buckets=[(15.0, 256)], wire_format="int16", **common)
    doc_buckets = [(6.0, 40), (9.0, 27), (12.0, 20)]
    aug_doc = OnDeviceAugmenter(buckets=doc_buckets, wire_format="float32", **common)
    aug.precompile()
    aug_doc.precompile()
    batches = []
    for i in range(3):
        lens = rng.integers(8 * SR, 15 * SR + 1, size=256)
        lens[0] = 15 * SR
        audio = rng.standard_normal((256, 15 * SR), np.float32) * 0.1
        batches.append((audio, lens))
    doc_batches = []
    for sec, bsz in doc_buckets:
        lens = rng.integers(int((sec - 3) * SR), int(sec * SR) + 1, size=bsz - 1)
        lens[0] = int(sec * SR)
        audio = rng.standard_normal((bsz - 1, int(lens.max())), np.float32) * 0.1
        doc_batches.append((audio, lens))

    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    staged = [aug.stage(audio, lens) for audio, lens in batches]
    outs = [aug.compute(s) for s in staged]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    doc_outs = [aug_doc(audio, lens) for audio, lens in doc_batches]
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    print(f"main path: fbank kernel launches {launches}")
    if launches < len(batches) + len(doc_batches):
        raise AssertionError(f"the main path launched the fbank kernel {launches} times")

    audio_sec = sum(int(lens.sum()) for _, lens in batches) / SR
    print(f"15 s x 256 bucket, int16 wire: {len(batches)} batches, {audio_sec!r} audio-s in "
          f"{elapsed!r} s (stage + compute): {audio_sec / elapsed!r} audio-s/s")
    for (feats, feat_lens), (_, lens) in zip(outs, batches):
        if tuple(feats.shape) != (256, 1364, 80) or not torch.isfinite(feats).all():
            raise AssertionError(f"main-path features {tuple(feats.shape)} wrong or not finite")
        if not np.array_equal(feat_lens.cpu().numpy(), _expected_feat_lens(lens)):
            raise AssertionError("main-path feat_lens differ from the hop rule")
    for (feats, feat_lens), (sec, bsz), (_, lens) in zip(doc_outs, doc_buckets, doc_batches):
        frames = (math.ceil(int(sec * SR) * 10 / 11) + 80) // 160
        full_lens = np.zeros(bsz, np.int64)
        full_lens[: len(lens)] = lens
        if tuple(feats.shape) != (bsz, frames, 80) or not torch.isfinite(feats).all():
            raise AssertionError(f"{sec} s bucket features {tuple(feats.shape)} wrong or not finite")
        if not np.array_equal(feat_lens.cpu().numpy(), _expected_feat_lens(full_lens)):
            raise AssertionError(f"{sec} s bucket feat_lens differ from the hop rule")
        print(f"{sec} s x {bsz} bucket, float32 wire: features {tuple(feats.shape)} finite")

    _check_chain(staged[0], *outs[0], "int16", rir, device, fbank_cuda)

    # A small batch through the CPU port (plain versions throughout) as the
    # reference for the card's result.
    audio, lens = doc_batches[0][0][:4], doc_batches[0][1][:4]
    small = dict(common, device="cpu")
    cpu_feats, cpu_lens = OnDeviceAugmenter(buckets=[(6.0, 4)], **small)(audio, lens)
    gpu_feats, gpu_lens = OnDeviceAugmenter(buckets=[(6.0, 4)], **common)(audio, lens)
    cross_err = (gpu_feats.cpu() - cpu_feats).abs().max().item()
    print(f"6 s x 4 batch, card vs CPU port: max_abs_err {cross_err!r} (tol {CHAIN_TOL})")
    if not cross_err <= CHAIN_TOL or not torch.equal(gpu_lens.cpu(), cpu_lens):
        raise AssertionError("the card's result disagrees with the CPU port's")

    # -- 4. adpcm4 wire, 5. sample cache, 6. extractors -------------------------
    by_path = {"augment_int16": launches}
    by_path["augment_adpcm4"] = _phase_adpcm4(common, batches[0], rir, device, fbank_cuda, smi)
    extra = rng.integers(8 * SR, 15 * SR + 1, size=256)
    cache_batches = batches + [(rng.standard_normal((256, 15 * SR), np.float32) * 0.1, extra)]
    by_path["cached"] = _phase_cache(common, cache_batches, device, fbank_cuda)
    by_path.update(_phase_extractors(device, fbank_cuda, ops))

    # -- 7. model path, 8. entry, 9. WPE --------------------------------------
    by_path["model"] = _phase_model(common, rng, device, fbank_cuda)
    by_path["entry"] = _phase_entry(device, fbank_cuda)
    _phase_wpe(device)

    # -- 10. the host data path into the trainer step, 11. precomputed features,
    # 12. the augmented training path, 13. the Shar corpus path. One FLAC
    # corpus for the four phases.
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        cuts_path, noise_path = _synthesize_corpus(Path(tmp), E2E_RECORDINGS)
        print(f"e2e corpus: {E2E_RECORDINGS} FLAC recordings and a 4 x 10 s noise pool written "
              f"in {time.perf_counter() - t0!r} s")
        by_path.update(_phase_e2e(cuts_path, device, fbank_cuda, smi))
        launches_pre, pre_err = _phase_precomputed(cuts_path, Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_pre)
        t0 = time.perf_counter()
        launches_aug, aug_err = _phase_augmented(
            cuts_path, noise_path, Path(tmp) / "feats_cuts.jsonl", Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_aug)
        print(f"phase 12 took {time.perf_counter() - t0!r} s")
        t0 = time.perf_counter()
        launches_shar, shar_err = _phase_shar(
            cuts_path, Path(tmp) / "feats_cuts.jsonl", Path(tmp), device, fbank_cuda, smi)
        by_path.update(launches_shar)
        print(f"phase 13 took {time.perf_counter() - t0!r} s")
    print(f"fbank kernel launches by path: {by_path}")
    reads_stored = ("precomputed_train", "precomputed_mix", "shar_precomputed")
    if not all(n > 0 for path, n in by_path.items() if path not in reads_stored):
        raise AssertionError(f"a path did not launch the fbank kernel: {by_path}")

    record = {"kernels": [{
        "name": "fbank_logmel",
        "route": "cuda",
        "source": "lhotse_tpu_torch/csrc/fbank.cu",
        "replaces": "lhotse_tpu/ops/fbank_pallas.py:64",
        "launches": launches,
        "max_abs_err": max([c["max_abs_err"] for c in cases] + [pre_err, aug_err, shar_err]),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the Kaldi log-mel
        "device_ms": main_case["device_ms"],
        "plain_device_ms": main_case["plain_device_ms"],
        "cases": cases,
        "near_silent_err": {"kernel": kernel_err, "plain": plain_err},
        "launches_by_path": by_path,
    }]}
    print(f"chip_smoke.py wall time {time.perf_counter() - start!r} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
