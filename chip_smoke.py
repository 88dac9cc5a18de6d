"""
Smoke run of the PyTorch port on one CUDA card: builds the fbank kernel
from this checkout, holds it against its plain PyTorch version, drives the
on-device augment→fbank path through ``OnDeviceAugmenter`` at the 15 s ×
256 bucket with the int16 and the adpcm4 wire, through the device sample
cache over two epochs fed by ``transfer_stream``, and through the ``Fbank``
and ``Mfcc`` extractors on the card, and checks what comes out.

    python3 chip_smoke.py

It needs a CUDA card and the checkout beside it; without either it exits
non-zero and prints no result. It imports neither ``jax`` nor
``lhotse_tpu``. Every check raises on failure, so a zero exit means every
phase passed. The line before the last is a JSON record of the kernel
(launches on the main path, max-abs error against the plain version, per
call times by CUDA events and device times by ``torch.profiler`` for the
kernel and its plain version at each shape, the near-silent check against
float64, and the kernel's launches on each path); the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import queue
import subprocess
import sys
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


def _expected_feat_lens(lens: np.ndarray) -> np.ndarray:
    """ceil(lens · 16000 / 17600) samples after speed 1.1, then the hop rule."""
    return (-(-lens * 10 // 11) + 80) // 160


def _check_chain(staged, feats, feat_lens, wire_format, rir, device, fbank_cuda) -> float:
    """Max-abs of the path's features against the same chain with the
    kernel's plain version on the card (these plain runs launch no kernel);
    raises past ``CHAIN_TOL`` or on other ``feat_lens``."""
    from lhotse_tpu_torch.features.kaldi.layers import Wav2LogFilterBank
    from lhotse_tpu_torch.ops.augment import make_augment_fbank_pipeline

    plain_pipe = make_augment_fbank_pipeline(
        sampling_rate=SR, speed_factor=SPEED, wire_format=wire_format, rir=rir, device=device,
        fbank=_PlainFbank(Wav2LogFilterBank(device=device), fbank_cuda))
    plain_feats, plain_lens = plain_pipe(staged.audio, staged.lens, **staged.kwargs)
    err = (plain_feats - feats).abs().max().item()
    print(f"{wire_format} path vs the same chain with the plain fbank: max_abs_err {err!r} "
          f"(tol {CHAIN_TOL})")
    if not err <= CHAIN_TOL or not torch.equal(plain_lens, feat_lens):
        raise AssertionError(f"the {wire_format} path disagrees with the plain chain")
    return err


def _phase_adpcm4(common, batch, rir, device, fbank_cuda) -> int:
    """4. The adpcm4 wire at the full bucket: the card's decode of a staged
    batch against the numpy decode bit for bit, the features against the
    plain chain. Returns the kernel's launches on the path."""
    from lhotse_tpu_torch.dataset.device_augment import OnDeviceAugmenter
    from lhotse_tpu_torch.ops import wire

    from lhotse_tpu_torch.dataset import device_augment

    aug = OnDeviceAugmenter(buckets=[BUCKET], wire_format="adpcm4", **common)
    audio, lens = batch
    encode_s = []

    def timed_encode(x, wire_format):  # the stage's own encode, timed
        t = time.perf_counter()
        out = wire.encode_wire(x, wire_format)
        encode_s.append(time.perf_counter() - t)
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
    encode_ms = encode_s[0] * 1e3
    feats, feat_lens = aug.compute(staged)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    elapsed = time.perf_counter() - t0
    decoded = wire.decode_wire(staged.audio, "adpcm4")
    if not torch.equal(decoded.cpu(), torch.from_numpy(wire.adpcm4_decode_np(staged.audio.cpu().numpy()))):
        raise AssertionError("the card's adpcm4 decode differs from adpcm4_decode_np")
    decode_ms = _device_ms(lambda: wire.decode_wire(staged.audio, "adpcm4"))
    width = tuple(staged.audio.shape)
    print(f"adpcm4 {BUCKET[0]:g} s x {BUCKET[1]}: wire {width} uint8 ({wire.wire_bytes_per_sample('adpcm4')} B/sample); "
          f"host encode {encode_ms!r} ms (numpy), stage {stage_ms!r} ms; decode on the card "
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
        flop = B * T * (400 * 256 * 4 + 256 * n_mels * 2)
        print(f"fbank B={B} T={T} n_mels={n_mels}: max_abs_err {case['max_abs_err']!r} "
              f"(tol {KERNEL_TOL}); per call (CUDA events, median of {TIMING_RUNS}) kernel "
              f"{case['ms']!r} ms, plain {case['plain_ms']!r} ms; device (torch.profiler) "
              f"kernel {case['device_ms']!r} ms ({flop / case['device_ms'] / 1e9:.1f} TFLOP/s), "
              f"plain {case['plain_device_ms']!r} ms")
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
    by_path["augment_adpcm4"] = _phase_adpcm4(common, batches[0], rir, device, fbank_cuda)
    extra = rng.integers(8 * SR, 15 * SR + 1, size=256)
    cache_batches = batches + [(rng.standard_normal((256, 15 * SR), np.float32) * 0.1, extra)]
    by_path["cached"] = _phase_cache(common, cache_batches, device, fbank_cuda)
    by_path.update(_phase_extractors(device, fbank_cuda, ops))
    print(f"fbank kernel launches by path: {by_path}")
    if not all(n > 0 for n in by_path.values()):
        raise AssertionError(f"a path did not launch the fbank kernel: {by_path}")

    record = {"kernels": [{
        "name": "fbank_logmel",
        "route": "cuda",
        "source": "lhotse_tpu_torch/csrc/fbank.cu",
        "replaces": "lhotse_tpu/ops/fbank_pallas.py:64",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
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
