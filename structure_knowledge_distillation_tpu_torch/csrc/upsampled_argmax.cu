// First-index argmax over classes of align-corners-upsampled logits.
//
// Replaces K1, the TPU kernel `upsampled_argmax` of
// structure_knowledge_distillation_tpu/ops/pallas_eval.py:87 (body
// `_argmax_kernel`, :76). That kernel interpolates a row block of every class
// as two dense MXU matmuls (Ah_blk·X·Awᵀ) in VMEM, because the MXU is the
// TPU's fast path. Each output pixel, though, depends on only 2×2 low-res
// taps per class, and the (N,C,H,W) upsampled tensor never has to exist.
//
// Design: one block per (image, low-res row interval, window of high-res
// columns). An interval is the high-res rows whose first row tap is one
// low-res row i (host table `row_start`, ops/taps.py tap_intervals), so every
// row of it reads only low-res rows i and i + 1; the block stages those two
// rows of the low-res columns its window reads, once. Per high-res row it
// interpolates along H once for the row, into pairs (V[col], V[col+1]) in
// shared memory; then each thread interpolates each class of its pixels once
// along W from one 8-byte pair load and keeps a running maximum in which the
// FIRST class wins a tie (strict `>`), as pallas_eval.py:81-84 and torch/jnp
// argmax do, and writes the pixel's class. Interpolation is height first,
// then width, every product and sum rounded on its own (no FMA), which is
// what the dense f32 matmuls compute; the weights come from host tables built
// from the same float64→float32 operator as the JAX package's matrices, so
// every interpolated value, and the class map, is the same as a tap-by-tap
// evaluation in that order.
//
// What bounds it on an H100: at Cityscapes full resolution the input is
// (1,19,129,257) logits, 2.5 MB in f32 (L2-resident), and the output an
// (1,1024,2048) int32 map, 8 MB written once: that write sets the bound
// (2.5 µs at 3.35 TB/s). The work is 19 classes per pixel, each a pair load,
// three rounded operations and a compare-and-select, so the kernel is bound
// by instruction issue; the design keeps that to one W interpolation per
// pixel and class (the H interpolation is shared by a row's pixels, the old
// per-pixel kernel redid it for each), no integer division per pixel, and
// class-minor pairs so that a pixel's classes sit at immediate offsets.
// Neighbouring threads own neighbouring pixels of a row, so the stores are
// coalesced.
//
// Launch contract (nvcc into a shared library, loaded with ctypes): the
// kernel runs on the caller's stream, never synchronises, allocates nothing,
// and the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPx = 2;      // pixels per thread: a window holds at most 512 columns
constexpr int kStage = 12;  // staging loads in flight per thread (20 spilled in bf16)
constexpr int kChunk = 18;  // classes unrolled per step of the class loop: the 18
// after the first of 19 in one step (4 and 9 ran slower)
// the H100's dynamic shared memory per block (opt-in above 48 KB)
constexpr int64_t kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Two-tap interpolation with every product and sum rounded separately (no
// FMA contraction), which is what a dense f32 matmul over an operator row with
// two non-zero entries computes.
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// q / d for 0 <= q < 2^22 and d >= 1: the f32 product with 1/d is within one
// of the quotient, and one step each way corrects it
__device__ __forceinline__ int div_small(int q, int d, float inv_d) {
  int r = __float2int_rz(__fmul_rn(__int2float_rn(q), inv_d));
  r -= r * d > q;
  r += (r + 1) * d <= q;
  return r;
}

// Block (image b, low-res row interval i, column window win), flattened into
// blockIdx.x = (b·h_in + i)·nwin + win. The interval is the high-res rows
// [row_start[i], row_start[i+1]) (empty where downsampling skips row i); the
// window is the high-res columns [win·px, (win+1)·px), whose column taps span
// the low-res columns cl .. cl + ncols − 1.
//
// Shared memory, class-minor (index col·c + k):
//   xs     (2, ncols, c)  low-res rows i and i + 1 (row i again where i is the
//                         last row), staged once, kStage loads in flight per
//                         thread, bf16 converted to f32;
//   pairs  (ncols, c)     float2 per high-res row: (V[col][k], V[col+1][k]),
//                         V the staged rows interpolated along H.
// A pixel whose first column tap is the window's last staged column has no
// second tap and a second weight of exactly 0 (ops/taps.py tap_tables): its
// pair's second value is the first again, finite, and adds 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) upsampled_argmax_kernel(
    const T* __restrict__ logits, const int* __restrict__ row_idx,
    const float* __restrict__ row_wt, const int* __restrict__ col_idx,
    const float* __restrict__ col_wt, const int* __restrict__ row_start, int* __restrict__ out,
    int c, int h_in, int w_in, int h_out, int w_out, int px) {
  extern __shared__ float smem[];
  const int nwin = (w_out + px - 1) / px;
  const int win = blockIdx.x % nwin;
  const int bi = blockIdx.x / nwin;
  const int i = bi % h_in, b = bi / h_in;
  const int y_begin = row_start[i], y_end = row_start[i + 1];
  if (y_begin >= y_end) return;  // the whole block: no high-res row has this first tap

  const int x0 = win * px, x1 = min(x0 + px, w_out);
  const int cl = col_idx[x0];
  const int ncols = col_idx[w_out + x1 - 1] - cl + 1;
  const int nv = c * ncols;
  float* xs = smem;
  float2* pairs = reinterpret_cast<float2*>(xs + 2 * nv);

  // staging: element q of the global walk is column q % ncols of channel row
  // q / ncols = r·c + k (coalesced reads along a low-res row)
  const int64_t plane = static_cast<int64_t>(h_in) * w_in;
  const T* src = logits + static_cast<int64_t>(b) * c * plane + cl;
  const int64_t off0 = static_cast<int64_t>(i) * w_in;
  const int64_t off1 = static_cast<int64_t>(min(i + 1, h_in - 1)) * w_in;
  const float inv_ncols = __frcp_rn(static_cast<float>(ncols));
  for (int q0 = threadIdx.x; q0 < 2 * nv; q0 += kStage * kThreads) {
    float val[kStage];
    int dst[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int q = q0 + u * kThreads;
      val[u] = 0.0f;
      dst[u] = -1;
      if (q < 2 * nv) {
        const int rk = div_small(q, ncols, inv_ncols);
        const int col = q - rk * ncols;
        const int r = rk >= c ? 1 : 0;
        const int k = rk - r * c;
        val[u] = load_f32(src + k * plane + (r ? off1 : off0) + col);
        dst[u] = r * nv + col * c + k;
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      if (dst[u] >= 0) xs[dst[u]] = val[u];
    }
  }

  // this thread's pixels: the offset of their first pair and their column
  // weights, in registers for the whole interval
  int lo[kPx];
  float wx0[kPx], wx1[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const int x = x0 + threadIdx.x + j * kThreads;
    const bool act = x < x1;
    lo[j] = act ? (col_idx[x] - cl) * c : 0;
    wx0[j] = act ? col_wt[x] : 0.0f;
    wx1[j] = act ? col_wt[w_out + x] : 0.0f;
  }
  int* out_img = out + static_cast<int64_t>(b) * h_out * w_out;
  float wy0_next = row_wt[y_begin], wy1_next = row_wt[h_out + y_begin];
  int hi_next = row_idx[h_out + y_begin];
  for (int y = y_begin; y < y_end; ++y) {
    const float wy0 = wy0_next, wy1 = wy1_next;
    const int hi_off = hi_next == i ? 0 : nv;
    if (y + 1 < y_end) {
      wy0_next = row_wt[y + 1];
      wy1_next = row_wt[h_out + y + 1];
      hi_next = row_idx[h_out + y + 1];
    }
    float* vf = reinterpret_cast<float*>(pairs);
    __syncthreads();  // the staging, or the previous row's reads of the pairs, are done
    // V: value q is the first of pair q and the second of pair q − c
    for (int q = threadIdx.x; q < nv; q += kThreads) {
      const float val = lerp2(wy0, xs[q], wy1, xs[hi_off + q]);
      vf[2 * q] = val;
      if (q >= c) vf[2 * (q - c) + 1] = val;
      if (q >= nv - c) vf[2 * q + 1] = val;
    }
    __syncthreads();
    // each pixel: every class once along W, a running max, first index wins
    const float2* pp[kPx];
    float best[kPx];
    int best_k[kPx];
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      pp[j] = pairs + lo[j];
      const float2 t = pp[j][0];
      best[j] = lerp2(wx0[j], t.x, wx1[j], t.y);
      best_k[j] = 0;
    }
    int k = 1;
    for (; k + kChunk <= c; k += kChunk) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int j = 0; j < kPx; ++j) {
          const float2 t = pp[j][k + u];
          const float val = lerp2(wx0[j], t.x, wx1[j], t.y);
          if (val > best[j]) {
            best[j] = val;
            best_k[j] = k + u;
          }
        }
      }
    }
    for (; k < c; ++k) {
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const float2 t = pp[j][k];
        const float val = lerp2(wx0[j], t.x, wx1[j], t.y);
        if (val > best[j]) {
          best[j] = val;
          best_k[j] = k;
        }
      }
    }
    int* out_row = out_img + static_cast<int64_t>(y) * w_out;
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int x = x0 + threadIdx.x + j * kThreads;
      if (x < x1) out_row[x] = best_k[j];
    }
  }
}

// The kernel's dynamic shared memory for windows that read at most `ncols`
// low-res columns: the staged rows and the pairs, 4·c·ncols floats
// (ops/taps.py window_smem_bytes mirrors it).
int64_t window_smem_bytes(int c, int ncols) { return 16 * static_cast<int64_t>(c) * ncols; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers of
// contiguous tensors: logits (n, c, h_in, w_in), out (n, h_out, w_out) int32;
// row_idx/row_wt (2, h_out) and col_idx/col_wt (2, w_out) the (lo, hi) taps
// and their weights (ops/taps.py tap_tables); row_start (h_in + 1,) int32, the
// high-res rows whose first tap is each low-res row, [start[i], start[i+1]).
// px: high-res columns per block, at most kThreads·kPx; ncols_max: the most
// low-res columns any window of px columns reads (ops/taps.py window_tiling),
// which sets the dynamic shared memory (opted in above 48 KB).
extern "C" int skd_upsampled_argmax(const void* logits, int dtype, const void* row_idx,
                                    const void* row_wt, const void* col_idx, const void* col_wt,
                                    const void* row_start, void* out, int n, int c, int h_in,
                                    int w_in, int h_out, int w_out, int px, int ncols_max,
                                    void* stream) {
  if (n <= 0 || c <= 0 || h_in <= 0 || w_in <= 0 || h_out <= 0 || w_out <= 0 ||
      (dtype != 0 && dtype != 1) || px <= 0 || px > kThreads * kPx || ncols_max <= 0 ||
      ncols_max > w_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = window_smem_bytes(c, ncols_max);
  const int64_t blocks = static_cast<int64_t>(n) * h_in * ((w_out + px - 1) / px);
  if (smem > kMaxSmemBytes || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ri = static_cast<const int*>(row_idx);
  const float* rw = static_cast<const float*>(row_wt);
  const int* ci = static_cast<const int*>(col_idx);
  const float* cw = static_cast<const float*>(col_wt);
  const int* rs = static_cast<const int*>(row_start);
  int* o = static_cast<int*>(out);
  cudaError_t err;
  if (dtype == 0) {
    auto kernel = upsampled_argmax_kernel<float>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess) {
      return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const float*>(logits), ri, rw, ci, cw, rs, o, c, h_in, w_in, h_out, w_out, px);
  } else {
    auto kernel = upsampled_argmax_kernel<__nv_bfloat16>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess) {
      return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(logits), ri, rw, ci, cw, rs, o, c, h_in, w_in, h_out,
        w_out, px);
  }
  return static_cast<int>(cudaGetLastError());
}
