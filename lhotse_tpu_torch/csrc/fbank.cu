// Fused Kaldi log-mel fbank for Hopper (sm_90a), IEEE fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernel `_kernel` of lhotse_tpu/ops/fbank_pallas.py
// (launched by `fbank_pallas`). It computes the same function, not the same
// blocks: frame i of an utterance is samples [160 i, 160 i + 400); the frame
// goes through the folded analysis matrices [Mc | Ms] (DC removal,
// pre-emphasis 0.97, povey window and the 512-point real DFT in one linear
// map, see lhotse_tpu_torch/ops/fbank.py), then power re^2 + im^2, the mel
// product, and log(max(., eps)). Frames never touch device memory: only the
// audio is read and only the (B, T, n_mels) log-mel is written.
//
// What bounds it on this card: fp32 FMAs and what feeds them. Per frame it
// does 400 x 2 x 256 multiply-adds for the spectrum against 640 bytes of new
// audio, far above the H100's fp32 ridge. The parity budget (5e-5 on the
// log-mel) rules out TF32 and bf16x3 tensor-core products (the JAX package
// measured bf16x3 ~1.4e-3 off), so the work runs as fp32 FMAs on the CUDA
// cores, fed from shared memory: the 800 KB DFT operand does not fit in L1,
// and a design that streams it from L2 for every few frames waits on it.
// Shared memory is itself a limit: a warp-wide broadcast float4 load issues
// at about half a warp-load per clock per SM, so a lane needs a register
// tile large enough that its loads take less time than its FMAs.
//
// What the design does about it:
// - The bins are split into 64-bin quarters (two for 128 bins). Each block
//   computes one quarter for a tile of 128 frames; the quarters of one tile
//   form a thread-block cluster along x.
// - The block's quarter of [Mc | Ms], packed (bins / 64, 400, 128) by
//   `pack_dft` so that 16 rows are 8 contiguous KB, streams through a ring
//   of 4 slots, one Hopper bulk copy (cp.async.bulk) per slot completing on
//   an mbarrier. The copy takes uniform operands, so one large copy, not one
//   per lane. The last warp done with a slot refills it (a counter in shared
//   memory): no warp waits on another, only on data. Every operand fetched
//   from L2 serves the block's 128 frames.
// - The tile's audio span (127 x 160 + 400 samples) is staged in shared
//   memory by bulk copies of a 16-byte aligned row, and by the threads for
//   what those do not cover (an unaligned row, its last samples, zeros past
//   its end).
// - Each warp owns 16 frames and each lane 2 bins x (re, im): 64
//   accumulators. Per 4 k-steps a lane reads 4 operand rows as float2s and
//   each frame's 4 samples as one broadcast float4, and issues 256 FMAs.
//   Each re and im is one accumulator summed over k = 0..399 in order.
// - The quarter's power (128 x 64) goes to shared memory over the ring. Mel
//   filter m sums only the bins between its first and last nonzero weight in
//   the quarter, in order; the skipped terms are exactly zero. The filters
//   go in chunks of 128: each chunk is a partial (128 x 128) tile over the
//   span.
// - After a cluster barrier, block r of the cluster sums its slice of frames
//   over the chunk's partial tiles of ranks 0..Q-1 in that order through
//   distributed shared memory, takes the eps-floored log and stores it; a
//   second barrier frees the tiles for the next chunk. No atomics touch the
//   output: it is the same from run to run.
// - 115,704 bytes of shared memory and __launch_bounds__(256, 2): two
//   blocks per SM. The frame tail of an utterance that is no multiple of
//   128 is masked: samples past the end load as 0 and frames past the end
//   are not stored.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes from lhotse_tpu_torch/ops/fbank_cuda.py. The
// launch goes on the caller's stream; the function returns the launch's
// cudaError_t.

#include <atomic>
#include <cstdint>
#include <initializer_list>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFrameLen = 400;
constexpr int kHop = 160;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;                                // per SM
constexpr int kWarps = kThreads / 32;
constexpr int kQuarter = 64;                                 // bins per block, 2 per lane
constexpr int kFramesPerWarp = 16;
constexpr int kTileFrames = kWarps * kFramesPerWarp;         // 128
constexpr int kRowFloats = 2 * kQuarter;                     // a ring row: 64 re | 64 im
constexpr int kSliceRows = 16;
constexpr int kSlices = kFrameLen / kSliceRows;              // 25
constexpr int kStages = 4;
constexpr int kSliceFloats = kSliceRows * kRowFloats;
constexpr unsigned kSliceBytes = kSliceFloats * sizeof(float);  // 8 KB
constexpr int kMelChunk = 128;                               // mel filters per partial tile
constexpr int kSpan = (kTileFrames - 1) * kHop + kFrameLen;  // 20720 samples
constexpr int kRingBytes = kStages * kSliceFloats * sizeof(float);
constexpr int kSpanBytes = kSpan * sizeof(float);
constexpr int kPartialBytes = kTileFrames * kMelChunk * sizeof(float);
// The filters' bin ranges (2 bytes each) sit in the span after the partial tile.
constexpr int kMaxMels = 8192;
constexpr int kSpanChunk = 4096;                             // samples per bulk copy
constexpr int kSmemBytes =
    kRingBytes + kSpanBytes + (kStages + 1) * sizeof(uint64_t) + kStages * sizeof(unsigned);

static_assert(kFrameLen % kSliceRows == 0, "whole slices");
static_assert(kTileFrames * kQuarter * sizeof(float) <= kRingBytes, "the power tile fits the ring");
static_assert(kPartialBytes + kMaxMels * sizeof(unsigned short) <= kSpanBytes,
              "the partial tile and the mel ranges fit the span");
static_assert(kHop % 4 == 0 && kSliceRows % 4 == 0, "frames are read as aligned float4s");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One thread's bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Slice s (rows [16 s, 16 s + 16)) of this block's quarter of the packed
// operand into a ring slot: 8 KB, contiguous, one copy.
__device__ __forceinline__ void issue_slice(float* dst, uint32_t bar, const float* quarter,
                                            int s) {
  expect_bytes(bar, kSliceBytes);
  bulk_copy(dst, quarter + s * kSliceFloats, kSliceBytes, bar);
}

// The first n samples (a multiple of 4) of the tile's span from a 16-byte
// aligned row, in copies of kSpanChunk samples.
__device__ __forceinline__ void issue_span(float* span, uint32_t bar, const float* src, int n) {
  expect_bytes(bar, n * sizeof(float));
  for (int i = 0; i < n; i += kSpanChunk)
    bulk_copy(span + i, src + i, min(kSpanChunk, n - i) * sizeof(float), bar);
}

// The bins [lo, hi) of a quarter between mel filter m's first and last
// nonzero weight, as lo | hi << 8 (0 when the quarter holds none): the
// filter's sum skips the others, whose terms are exactly zero, and keeps
// the order of the rest.
__device__ __forceinline__ unsigned mel_range(const float* mel_rows, int n_mels, int m) {
  int lo = kQuarter, hi = 0;
#pragma unroll 16
  for (int k = 0; k < kQuarter; ++k)
    if (__ldg(mel_rows + k * n_mels + m) != 0.f) lo = min(lo, k), hi = k + 1;
  return lo < hi ? lo | hi << 8 : 0;
}

// Q quarters of 64 bins: a cluster of Q blocks per tile of 128 frames.
template <int Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fbank_logmel_kernel(const float* __restrict__ audio, const float* __restrict__ dft,
                    const float* __restrict__ mel,
                    float* __restrict__ out, int n_samples, int row_stride, int n_frames,
                    int n_mels, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);                    // kStages slices
  float* span = reinterpret_cast<float*>(smem_raw + kRingBytes);       // kSpan samples
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + kRingBytes + kSpanBytes);
  unsigned* done = reinterpret_cast<unsigned*>(bars + kStages + 1);  // warps done, per slot
  float* power = ring;  // (kTileFrames, kQuarter) once the DFT is done
  float* partial = span;  // (kTileFrames, kMelChunk) once the DFT is done

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int bin0 = q * kQuarter;
  const float* quarter = dft + static_cast<size_t>(q) * kFrameLen * kRowFloats;
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x / Q) * kTileFrames;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t bar0 = smem_addr(bars);  // kStages ring slots, then the span
  const uint32_t span_bar = bar0 + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar0 + 8 * i) : "memory");
    for (int i = 0; i < kStages; ++i) done[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The tile's audio and the first ring slices by bulk copies; the threads
  // load what the copies do not cover: the span of a row that is not 16-byte
  // aligned, the last samples of a row, and the zeros past its end.
  const float* x = audio + static_cast<size_t>(b) * row_stride;
  const long long start = static_cast<long long>(t0) * kHop;
  const long long avail = n_samples - start;  // >= 400: the tile holds a frame
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int n_bulk = aligned ? static_cast<int>(avail < kSpan ? avail : kSpan) & ~3 : 0;
  if (threadIdx.x == 0) {
    if (n_bulk > 0) issue_span(span, span_bar, x + start, n_bulk);
    for (int s = 0; s < kStages; ++s) issue_slice(ring + s * kSliceFloats, bar0 + 8 * s, quarter, s);
  }
  for (int i = n_bulk + threadIdx.x; i < kSpan; i += kThreads) {
    const long long s = start + i;
    span[i] = s < n_samples ? __ldg(x + s) : 0.f;
  }
  // Thread m finds mel filter m's bins while the copies are in flight;
  // filters past the block's threads wait until after the DFT.
  const float* mel_rows = mel + static_cast<size_t>(bin0) * n_mels;
  const unsigned range = threadIdx.x < n_mels ? mel_range(mel_rows, n_mels, threadIdx.x) : 0;
  __syncthreads();
  if (n_bulk > 0) mbar_wait(span_bar, 0);

  // -- DFT: 16 frames x 2 bins x (re, im) per lane, each sum over k in order --
  const int col = 2 * lane;  // this lane's first bin in the quarter
  float re[kFramesPerWarp][2];
  float im[kFramesPerWarp][2];
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f) re[f][0] = re[f][1] = im[f][0] = im[f][1] = 0.f;

  const float* frames = span + warp * kFramesPerWarp * kHop;
  for (int s = 0; s < kSlices; ++s) {
    const int slot = s % kStages;
    mbar_wait(bar0 + 8 * slot, (s / kStages) & 1);
    const float* op = ring + slot * kSliceFloats + col;
    const float* fr = frames + s * kSliceRows;
#pragma unroll
    for (int k4 = 0; k4 < kSliceRows; k4 += 4) {
      float2 c[4], sn[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = *reinterpret_cast<const float2*>(op + (k4 + u) * kRowFloats);
        sn[u] = *reinterpret_cast<const float2*>(op + (k4 + u) * kRowFloats + kQuarter);
      }
#pragma unroll
      for (int f = 0; f < kFramesPerWarp; ++f) {
        const float4 a4 = *reinterpret_cast<const float4*>(fr + f * kHop + k4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          re[f][0] = fmaf(a[u], c[u].x, re[f][0]);
          im[f][0] = fmaf(a[u], sn[u].x, im[f][0]);
          re[f][1] = fmaf(a[u], c[u].y, re[f][1]);
          im[f][1] = fmaf(a[u], sn[u].y, im[f][1]);
        }
      }
    }
    // The last warp done with this slot refills it: no warp waits for the
    // others except on the data it needs.
    if (s + kStages < kSlices) {
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        if ((atomicAdd(done + slot, 1u) + 1) % kWarps == 0) {
          __threadfence_block();
          issue_slice(ring + slot * kSliceFloats, bar0 + 8 * slot, quarter, s + kStages);
        }
      }
    }
  }
  __syncthreads();  // the ring and the span are free
  unsigned short* ranges = reinterpret_cast<unsigned short*>(span + kTileFrames * kMelChunk);
  if (threadIdx.x < n_mels) ranges[threadIdx.x] = static_cast<unsigned short>(range);
  for (int m = kThreads + threadIdx.x; m < n_mels; m += kThreads)
    ranges[m] = static_cast<unsigned short>(mel_range(mel_rows, n_mels, m));

  // -- power ----------------------------------------------------------------
  float* pow_rows = power + warp * kFramesPerWarp * kQuarter;
#pragma unroll
  for (int f = 0; f < kFramesPerWarp; ++f)
    *reinterpret_cast<float2*>(pow_rows + f * kQuarter + col) =
        make_float2(re[f][0] * re[f][0] + im[f][0] * im[f][0],
                    re[f][1] * re[f][1] + im[f][1] * im[f][1]);
  __syncthreads();  // the power rows and the mel ranges are written

  // -- per chunk of filters: this quarter's share of the mel product, then
  // the sum of the Q partial tiles across the cluster, log, store ----------
  constexpr int kRows = kTileFrames / Q;
  const int f0 = q * kRows;
  const int valid = min(kRows, n_frames - (t0 + f0));
  float* dst = out + (static_cast<size_t>(b) * n_frames + t0 + f0) * n_mels;
  const float* parts[Q];
#pragma unroll
  for (int r = 0; r < Q; ++r) parts[r] = cluster.map_shared_rank(partial, r);
  float* part_rows = partial + warp * kFramesPerWarp * kMelChunk;
  for (int c0 = 0; c0 < n_mels; c0 += kMelChunk) {
    const int nc = min(kMelChunk, n_mels - c0);
    if (c0 > 0) cluster.sync();  // every rank has read the last chunk's tile
    // A warp reads back only the power rows of its own frames, and writes
    // only its own rows of the partial tile.
    for (int m = lane; m < nc; m += 32) {
      const unsigned r = ranges[c0 + m];
      const int hi = r >> 8;
      const float* w_col = mel_rows + c0 + m;
      float acc[kFramesPerWarp];
#pragma unroll
      for (int f = 0; f < kFramesPerWarp; ++f) acc[f] = 0.f;
      int k = r & 0xff;
      float w = k < hi ? __ldg(w_col + k * n_mels) : 0.f;
      for (; k < hi; ++k) {
        const float cur = w;
        if (k + 1 < hi) w = __ldg(w_col + (k + 1) * n_mels);
#pragma unroll
        for (int f = 0; f < kFramesPerWarp; ++f) acc[f] = fmaf(pow_rows[f * kQuarter + k], cur, acc[f]);
      }
#pragma unroll
      for (int f = 0; f < kFramesPerWarp; ++f) part_rows[f * kMelChunk + m] = acc[f];
    }
    cluster.sync();
    if (valid > 0) {
      const int count = valid * nc;
#pragma unroll 4
      for (int i = threadIdx.x; i < count; i += kThreads) {
        const int f = i / nc;
        const int j = i - f * nc;
        const int off = (f0 + f) * kMelChunk + j;
        float v = parts[0][off];
#pragma unroll
        for (int r = 1; r < Q; ++r) v += parts[r][off];
        dst[f * n_mels + c0 + j] = logf(fmaxf(v, eps));
      }
    }
  }
  // No block leaves while another still reads its tile; nothing is
  // published here, so the arrival is relaxed.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int Q>
cudaError_t launch(const float* audio, const float* dft, const float* mel,
                   float* out, int batch, int n_samples, int row_stride, int n_frames,
                   int n_mels, float eps, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q * ((n_frames + kTileFrames - 1) / kTileFrames), batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fbank_logmel_kernel<Q>, audio, dft, mel, out, n_samples,
                            row_stride, n_frames, n_mels, eps);
}

// The shared-memory size and carveout are set once per device, not per launch.
cudaError_t configure_device() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  for (const void* fn : {reinterpret_cast<const void*>(fbank_logmel_kernel<2>),
                         reinterpret_cast<const void*>(fbank_logmel_kernel<4>)}) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

}  // namespace

// audio (B, n_samples), rows row_stride floats apart, with
// n_frames = (n_samples - 400) / 160 + 1; dft (bins / 64, 400, 128), the
// packed [Mc | Ms] of lhotse_tpu_torch.ops.fbank_cuda.pack_dft, with bins
// 128 or 256; mel (bins, n_mels) with n_mels <= 8192; out (B, n_frames,
// n_mels). All float32; dft, mel and out contiguous, dft 16-byte aligned.
// The caller checks these. Returns a cudaError_t as int.
extern "C" int fbank_logmel_f32(const void* audio, const void* dft, const void* mel, void* out,
                                int batch, int n_samples, int row_stride, int n_frames, int bins,
                                int n_mels, float eps, void* stream) {
  cudaError_t err = configure_device();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* a = static_cast<const float*>(audio);
  const auto* w = static_cast<const float*>(dft);
  const auto* m = static_cast<const float*>(mel);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (bins == 4 * kQuarter)
    err = launch<4>(a, w, m, o, batch, n_samples, row_stride, n_frames, n_mels, eps, st);
  else if (bins == 2 * kQuarter)
    err = launch<2>(a, w, m, o, batch, n_samples, row_stride, n_frames, n_mels, eps, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The limit the Python wrapper checks against, read from here so the two
// cannot drift apart.
extern "C" int fbank_logmel_max_mels() { return kMaxMels; }
