// Fused Kaldi log-mel fbank for Hopper (sm_90a), IEEE fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernel `_kernel` of lhotse_tpu/ops/fbank_pallas.py
// (launched by `fbank_pallas`). It computes the same function, not the same
// blocks: frame i of an utterance is samples [160 i, 160 i + 400); the frame
// goes through the folded analysis matrices [Mc | Ms] (DC removal,
// pre-emphasis 0.97, povey window and the 512-point real DFT in one linear
// map, see lhotse_tpu_torch/ops/fbank.py), then power re^2 + im^2, the mel
// GEMM, and log(max(., eps)). Frames never touch device memory: only the
// audio is read and only the (B, T, n_mels) log-mel is written.
//
// What bounds it on this card: arithmetic. Per frame it does 400 x 2 x 256
// multiply-adds for the spectrum and 256 x n_mels for the mel bank, against
// 640 bytes of new audio and 320 bytes of output (80 mels), so it is some
// 500 FLOP per byte, far above the H100's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20). The parity budget (5e-5 on the log-mel) rules out TF32 and
// bf16x3 tensor-core products (the JAX package measured bf16x3 ~1.4e-3 off),
// so the work runs as fp32 FMAs on the CUDA cores.
//
// What the design does about it: one block takes a tile of 64 frames of one
// utterance and stages their contiguous span of 63 x 160 + 400 samples in
// shared memory once; the overlapping frames are read from there. Each warp
// owns 8 frames and each lane 4 bins, so every lane keeps an 8 x 4 register
// tile of re and of im: per DFT row it reads one float4 of Mc and of Ms
// (coalesced across the warp, served from L1/L2: the matrices are 800 KB and
// every block reads the same rows) and 8 broadcast samples from shared
// memory, and issues 64 FMAs. The power of a 128-bin chunk goes to a shared
// tile that only the owning warp reads back, and the mel product
// accumulates into 8 x 4 registers per lane (n_mels <= 128). The frame tail
// of an utterance that is no multiple of 64 is masked: samples past the end
// load as 0 and frames past the end are not stored.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes from lhotse_tpu_torch/ops/fbank_cuda.py. The
// launch goes on the caller's stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kFrameLen = 400;
constexpr int kHop = 160;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFramesPerWarp = 8;
constexpr int kTileFrames = kWarps * kFramesPerWarp;         // 64
constexpr int kBinChunk = 128;                               // 4 bins per lane
constexpr int kMaxMels = 128;                                // 4 mels per lane
constexpr int kMelsPerLane = kMaxMels / 32;
constexpr int kSpan = (kTileFrames - 1) * kHop + kFrameLen;  // 10480 samples
constexpr int kSmemBytes = (kSpan + kTileFrames * kBinChunk) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
fbank_logmel_kernel(const float* __restrict__ audio, const float* __restrict__ mc,
                    const float* __restrict__ ms, const float* __restrict__ mel,
                    float* __restrict__ out, int n_samples, int row_stride, int n_frames,
                    int bins, int n_mels, float eps) {
  extern __shared__ float smem[];
  float* span = smem;                 // kSpan samples of this tile
  float* power = smem + kSpan;        // kTileFrames x kBinChunk

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* x = audio + static_cast<size_t>(b) * row_stride;
  const long long start = static_cast<long long>(t0) * kHop;
  for (int i = threadIdx.x; i < kSpan; i += kThreads) {
    const long long s = start + i;
    span[i] = s < n_samples ? x[s] : 0.f;
  }
  __syncthreads();

  const float* frames = span + warp * kFramesPerWarp * kHop;  // this warp's first frame
  float* pow_rows = power + warp * kFramesPerWarp * kBinChunk;
  const int row4 = bins / 4;

  float acc[kFramesPerWarp][kMelsPerLane];
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kMelsPerLane; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < bins; c0 += kBinChunk) {
    float re[kFramesPerWarp][4];
    float im[kFramesPerWarp][4];
#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) re[i][q] = im[i][q] = 0.f;

    const float4* mc4 = reinterpret_cast<const float4*>(mc + c0) + lane;
    const float4* ms4 = reinterpret_cast<const float4*>(ms + c0) + lane;
#pragma unroll 2
    for (int k = 0; k < kFrameLen; ++k) {
      const float4 c = __ldg(mc4 + k * row4);
      const float4 s = __ldg(ms4 + k * row4);
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) {
        const float a = frames[i * kHop + k];
        re[i][0] = fmaf(a, c.x, re[i][0]);
        re[i][1] = fmaf(a, c.y, re[i][1]);
        re[i][2] = fmaf(a, c.z, re[i][2]);
        re[i][3] = fmaf(a, c.w, re[i][3]);
        im[i][0] = fmaf(a, s.x, im[i][0]);
        im[i][1] = fmaf(a, s.y, im[i][1]);
        im[i][2] = fmaf(a, s.z, im[i][2]);
        im[i][3] = fmaf(a, s.w, im[i][3]);
      }
    }

#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i) {
      float4 p;
      p.x = re[i][0] * re[i][0] + im[i][0] * im[i][0];
      p.y = re[i][1] * re[i][1] + im[i][1] * im[i][1];
      p.z = re[i][2] * re[i][2] + im[i][2] * im[i][2];
      p.w = re[i][3] * re[i][3] + im[i][3] * im[i][3];
      reinterpret_cast<float4*>(pow_rows + i * kBinChunk)[lane] = p;
    }
    __syncwarp();  // the power rows are read back by the warp that wrote them

    const float* mel_rows = mel + static_cast<size_t>(c0) * n_mels;
#pragma unroll 4
    for (int k = 0; k < kBinChunk; ++k) {
      float w[kMelsPerLane];
#pragma unroll
      for (int j = 0; j < kMelsPerLane; ++j) {
        const int m = lane + 32 * j;
        w[j] = m < n_mels ? __ldg(mel_rows + k * n_mels + m) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) {
        const float p = pow_rows[i * kBinChunk + k];
#pragma unroll
        for (int j = 0; j < kMelsPerLane; ++j) acc[i][j] = fmaf(p, w[j], acc[i][j]);
      }
    }
    __syncwarp();  // before the next chunk overwrites the power rows
  }

#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i) {
    const int f = t0 + warp * kFramesPerWarp + i;
    if (f >= n_frames) continue;
    float* row = out + (static_cast<size_t>(b) * n_frames + f) * n_mels;
#pragma unroll
    for (int j = 0; j < kMelsPerLane; ++j) {
      const int m = lane + 32 * j;
      if (m < n_mels) row[m] = logf(fmaxf(acc[i][j], eps));
    }
  }
}

}  // namespace

// audio (B, n_samples), rows row_stride floats apart, with
// n_frames = (n_samples - 400) / 160 + 1; mc, ms (400, bins) with bins a
// multiple of 128; mel (bins, n_mels) with n_mels <= 128; out
// (B, n_frames, n_mels). All float32; the matrices and the output contiguous
// and 16-byte aligned. The caller checks these. Returns a cudaError_t as int.
extern "C" int fbank_logmel_f32(const void* audio, const void* mc, const void* ms,
                                const void* mel, void* out, int batch, int n_samples,
                                int row_stride, int n_frames, int bins, int n_mels,
                                float eps, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fbank_logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames, batch);
  fbank_logmel_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(mc),
      static_cast<const float*>(ms), static_cast<const float*>(mel),
      static_cast<float*>(out), n_samples, row_stride, n_frames, bins, n_mels, eps);
  return static_cast<int>(cudaGetLastError());
}

// Limits the Python wrapper checks against, read from here so they cannot
// drift apart.
extern "C" int fbank_logmel_max_mels() { return kMaxMels; }
extern "C" int fbank_logmel_bin_chunk() { return kBinChunk; }
