// First-index argmax over classes of align-corners-upsampled logits.
//
// Replaces K1, the TPU kernel `upsampled_argmax` of
// structure_knowledge_distillation_tpu/ops/pallas_eval.py:87 (body
// `_argmax_kernel`, :76). That kernel interpolates a row block of every class
// as two dense MXU matmuls (Ah_blk·X·Awᵀ) in VMEM, because the MXU is the
// TPU's fast path. Each output pixel, though, depends on only 2×2 low-res
// taps per class, so here one thread owns one output pixel: it loops over the
// C classes, interpolates height first and then width, and keeps a running
// maximum in which the FIRST class wins a tie (strict `>`), as
// pallas_eval.py:81-84 and torch/jnp argmax do. The (N,C,H,W) upsampled
// tensor never exists.
//
// What bounds it on an H100: at Cityscapes full resolution the input is
// (1,19,129,257) logits, 2.5 MB in f32, which stays resident in the 50 MB L2
// after the first touch, while the (1,1024,2048) int32 output is 8 MB written
// once to device memory. The design keeps the writes to that one coalesced
// 4-byte store per pixel (neighbouring threads own neighbouring pixels of a
// row) and serves the 4·C tap reads from L1/L2: a warp's 32 pixels share at
// most 5-6 distinct source columns at the 8× upsampling of the eval path.
// The interpolation weights come in from per-row and per-column tables that
// the wrapper builds from the same float64→float32 operator as the JAX
// package, so they are bit-identical to its matrices' entries.
//
// Launch contract (route (b) of the port: nvcc into a shared library, loaded
// with ctypes): the kernel runs on the caller's stream, never synchronises,
// allocates nothing, and the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

// idx/wt tables are (2, n_out): row 0 holds the low tap and its weight, row 1
// the high tap and its weight. On the last row/column lo == hi and the high
// weight is 0.
template <typename T>
__global__ void upsampled_argmax_kernel(const T* __restrict__ logits,
                                        const int* __restrict__ row_idx,
                                        const float* __restrict__ row_wt,
                                        const int* __restrict__ col_idx,
                                        const float* __restrict__ col_wt,
                                        int* __restrict__ out, int n, int c,
                                        int h_in, int w_in, int h_out,
                                        int w_out) {
  const int64_t total = static_cast<int64_t>(n) * h_out * w_out;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;  // ragged edge: no h_out or w_out multiple needed
  const int x = static_cast<int>(p % w_out);
  const int64_t t = p / w_out;
  const int y = static_cast<int>(t % h_out);
  const int b = static_cast<int>(t / h_out);

  const int y0 = row_idx[y], y1 = row_idx[h_out + y];
  const float wy0 = row_wt[y], wy1 = row_wt[h_out + y];
  const int x0 = col_idx[x], x1 = col_idx[w_out + x];
  const float wx0 = col_wt[x], wx1 = col_wt[w_out + x];

  const int64_t plane = static_cast<int64_t>(h_in) * w_in;
  const int64_t o00 = static_cast<int64_t>(y0) * w_in + x0;
  const int64_t o01 = static_cast<int64_t>(y0) * w_in + x1;
  const int64_t o10 = static_cast<int64_t>(y1) * w_in + x0;
  const int64_t o11 = static_cast<int64_t>(y1) * w_in + x1;
  const T* src = logits + static_cast<int64_t>(b) * c * plane;

  float best = 0.0f;
  int best_k = 0;
  for (int k = 0; k < c; ++k, src += plane) {
    const float left = lerp2(wy0, load_f32(src + o00), wy1, load_f32(src + o10));
    const float right = lerp2(wy0, load_f32(src + o01), wy1, load_f32(src + o11));
    const float v = lerp2(wx0, left, wx1, right);
    if (k == 0 || v > best) {
      best = v;
      best_k = k;
    }
  }
  out[p] = best_k;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers of
// contiguous tensors: logits (n, c, h_in, w_in), out (n, h_out, w_out) int32.
extern "C" int skd_upsampled_argmax(const void* logits, int dtype,
                                    const void* row_idx, const void* row_wt,
                                    const void* col_idx, const void* col_wt,
                                    void* out, int n, int c, int h_in, int w_in,
                                    int h_out, int w_out, void* stream) {
  const int threads = 256;
  const int64_t total = static_cast<int64_t>(n) * h_out * w_out;
  const int64_t blocks = (total + threads - 1) / threads;
  if (total <= 0 || blocks > 0x7fffffff || c <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ri = static_cast<const int*>(row_idx);
  const float* rw = static_cast<const float*>(row_wt);
  const int* ci = static_cast<const int*>(col_idx);
  const float* cw = static_cast<const float*>(col_wt);
  int* o = static_cast<int*>(out);
  if (dtype == 0) {
    upsampled_argmax_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const float*>(logits), ri, rw, ci, cw, o, n, c, h_in, w_in,
        h_out, w_out);
  } else {
    upsampled_argmax_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), ri, rw, ci, cw, o, n, c, h_in,
        w_in, h_out, w_out);
  }
  return static_cast<int>(cudaGetLastError());
}
