// 3×3, stride-1, SAME (zero-padded) convolution with no bias, NHWC input,
// HWIO weights, f32 accumulation, output in the input's dtype.
//
// Replaces the TPU kernel of scripts/bench_pallas_conv.py:
//   K9 `pallas_conv3x3` (:62, body `_conv_kernel` :38), a feasibility probe
//   of a hand-written stem conv, with no caller in the package.
//
// The Pallas kernel feeds the TPU's matrix unit: each grid step takes a
// block of 16 rows plus a one-row halo from the neighbouring blocks, and
// adds 9 shifted (rows·W, Cin)·(Cin, Cout) matmuls into a VMEM accumulator.
// Those matmuls exist for the MXU; on the card this kernel computes the
// convolution in its own body on the CUDA cores:
//
//   block    a tile of kTH = 4 output rows × kTW = 32 output columns × kCT =
//            32 output channels of one image; one warp per output row, one
//            lane per output column, 32 f32 accumulators (the channels) per
//            thread.
//   shared   for each chunk of kCK = 16 input channels: the tile's input rows
//            plus a one-row (and one-column) halo on every side, (kCK, kTH +
//            2, kTW + 2) f32, zero where the halo falls outside the image (the
//            SAME padding at all four borders) or past Cin; and the chunk's
//            weights (9, kCK, kCT) f32, zero past Cin or Cout.
//   taps     each output sums 9·Cin products: for every input channel of the
//            chunk and every (dy, dx), one shared-memory read of the input
//            (lanes on consecutive words: no bank conflict) and 32 fused
//            multiply-adds against weights that every lane reads at the same
//            address (a broadcast), 4 at a time as float4.
//
// What bounds it on an H100: at the probe's shape, (8,256,256,64) bf16 with
// Cout = 128, the convolution is 77 GFLOP against 201 MB of input and output
// (67 MB in, 134 MB out). On the tensor cores that is about balanced: ≈ 60 µs
// of memory at 3.35 TB/s, ≈ 80 µs of bf16 matrix work at 989 TFLOP/s. On the
// CUDA cores in f32 (67 TFLOP/s at most), where this kernel runs, it cannot
// take less than about 1.2 ms: it is bound by fused multiply-adds and their
// shared-memory operands. This is a plain direct convolution; the tensor
// cores (wgmma) are the way to close the gap to cuDNN.
//
// Launch contract (nvcc into a shared library, loaded with ctypes): the
// kernel runs on the caller's stream, never synchronises, allocates nothing,
// and the C entry point returns the first cudaGetLastError() that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTH = 4;    // output rows per block (one warp each)
constexpr int kTW = 32;   // output columns per block (one lane each)
constexpr int kCT = 32;   // output channels per block (accumulators per thread)
constexpr int kCK = 16;   // input channels per shared-memory chunk
constexpr int kThreads = kTH * kTW;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid: (ceil(W/kTW), ceil(H/kTH), n·ceil(Cout/kCT)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int h,
                   int wd, int cin, int cout) {
  __shared__ float s_in[kCK][kTH + 2][kTW + 2];
  __shared__ __align__(16) float s_w[9][kCK][kCT];

  const int co_tiles = (cout + kCT - 1) / kCT;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kCT;
  const int r0 = blockIdx.y * kTH;
  const int c0 = blockIdx.x * kTW;
  const int tr = threadIdx.x / kTW;  // warp: output row in the tile
  const int tc = threadIdx.x % kTW;  // lane: output column in the tile
  const T* xb = x + static_cast<int64_t>(b) * h * wd * cin;

  float acc[kCT];
#pragma unroll
  for (int k = 0; k < kCT; ++k) acc[k] = 0.0f;

  for (int k0 = 0; k0 < cin; k0 += kCK) {
    __syncthreads();  // the previous chunk's reads are done
    // input tile + halo, input channels fastest (contiguous in NHWC)
    for (int i = threadIdx.x; i < kCK * (kTH + 2) * (kTW + 2); i += kThreads) {
      const int ci = i % kCK;
      const int cc = (i / kCK) % (kTW + 2);
      const int rr = i / (kCK * (kTW + 2));
      const int gy = r0 - 1 + rr, gx = c0 - 1 + cc;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && k0 + ci < cin) {
        v = load_f32(xb + (static_cast<int64_t>(gy) * wd + gx) * cin + k0 + ci);
      }
      s_in[ci][rr][cc] = v;
    }
    // weights of the chunk, output channels fastest (contiguous in HWIO)
    for (int i = threadIdx.x; i < 9 * kCK * kCT; i += kThreads) {
      const int co = i % kCT;
      const int ci = (i / kCT) % kCK;
      const int tap = i / (kCT * kCK);
      float v = 0.0f;
      if (k0 + ci < cin && co0 + co < cout) {
        v = load_f32(w + (static_cast<int64_t>(tap) * cin + k0 + ci) * cout + co0 + co);
      }
      s_w[tap][ci][co] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < kCK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float v = s_in[ci][tr + dy][tc + dx];
          const float4* wv = reinterpret_cast<const float4*>(s_w[dy * 3 + dx][ci]);
#pragma unroll
          for (int q = 0; q < kCT / 4; ++q) {
            const float4 wq = wv[q];
            acc[4 * q] = fmaf(v, wq.x, acc[4 * q]);
            acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
          }
        }
      }
    }
  }

  const int oy = r0 + tr, ox = c0 + tc;
  if (oy >= h || ox >= wd) return;
  T* o = out + ((static_cast<int64_t>(b) * h + oy) * wd + ox) * cout + co0;
#pragma unroll
  for (int k = 0; k < kCT; ++k) {
    if (co0 + k < cout) store(o + k, acc[k]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike). x: contiguous
// (n, h, w, cin); w: contiguous (3, 3, cin, cout); out: contiguous
// (n, h, w, cout).
extern "C" int skd_conv3x3(const void* x, const void* w, void* out, int dtype, int n, int h,
                           int wd, int cin, int cout, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t co_tiles = (cout + kCT - 1) / kCT;
  const int64_t gz = static_cast<int64_t>(n) * co_tiles;
  const int64_t gy = (h + kTH - 1) / kTH;
  if (gz > 65535 || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((wd + kTW - 1) / kTW), static_cast<unsigned>(gy),
                  static_cast<unsigned>(gz));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv3x3_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                     static_cast<const float*>(w),
                                                     static_cast<float*>(out), h, wd, cin, cout);
  } else {
    conv3x3_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), h, wd, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}
