// Ignore-masked mean cross-entropy over align-corners-upsampled logits, for
// one head or for the two DSN heads at once, forward and backward.
//
// Replaces the TPU kernels of structure_knowledge_distillation_tpu/ops/
// pallas_ce.py:
//   K2 `_run_fwd` (:183, body `_ce_fwd_kernel` :105)       -> forward, 1 head
//   K3 `_bwd` (:227, bodies `_ce_bwd_kernel` :126, `_accum_dx` :149)
//                                                          -> backward, 1 head
//   K4 `_run_dsn_fwd` (:315, body `_ce_dsn_fwd_kernel` :265) -> forward, 2 heads
//   K5 `_dsn_bwd` (:362, body `_ce_dsn_bwd_kernel` :289)   -> backward, 2 heads
// The one- and two-head versions are the same kernels with `nheads` 1 or 2.
//
// The Pallas kernels interpolate row blocks of every class with dense
// Ah·X·Awᵀ matmuls, because the MXU is the TPU's fast path, and carry their
// sums across a grid axis that the TPU runs in order (SMEM scalars, and a dX
// block zeroed at j == 0 and then accumulated). Neither carries over: each
// upsampled pixel reads only 2×2 low-res taps per class, and CUDA blocks run
// in parallel in no order. So:
//
//   forward  one thread owns one output pixel: it interpolates each class in
//            f32 (height first, then width, every product and sum rounded on
//            its own as the dense f32 matmuls do), takes each head's max,
//            log-sum-exp and picked logit, and masks label == ignore. A block
//            reduces its pixels in a fixed tree; a second kernel reduces the
//            per-block partials in a fixed order and forms
//            sum_main/max(count,1) + w·(sum_aux/max(count,1)) (pallas_ce.py:
//            343-350). The valid count is an exact integer.
//   backward the transpose of the interpolation, as two gathers (no float
//            atomics):
//            (a) one block per (image, high-res row): softmax statistics per
//                pixel into shared memory, then d_up = (softmax − onehot)·
//                mask·scale for a chunk of classes, contracted along W into
//                T (N, nheads·C, H, w_in): each low-res column sums the
//                contiguous range of high-res columns whose taps touch it
//                (ranges computed on the host from the same tap tables);
//            (b) one thread per low-res element contracts T along H in the
//                same way and writes dX once, in the logits' dtype, in f32
//                before the cast.
//            scale = g/max(count,1) for the main head and g·w/max(count,1)
//            for the aux head, read from device memory: no host sync.
//
// What bounds it on an H100 at the train shape, (8,19,65,65)×2 logits and
// (8,512,512) labels: the forward reads 1.3 MB of logits (L2-resident) and
// 8 MB of labels and writes almost nothing, so it is bound by instruction
// issue, 2·19 four-tap interpolations per pixel done twice (max, then
// exp-sum). The backward writes and reads T, 8·38·512·65·4 B = 40 MB, once
// each, and recomputes the interpolation for d_up rather than storing the
// (8,38,512,512) upsampled gradient (318 MB) that the plain version
// materialises. Results are bit-identical from run to run: every sum has a
// fixed order.
//
// Launch contract (nvcc into a shared library, loaded with ctypes): the
// kernels run on the caller's stream, never synchronise, allocate nothing,
// and each C entry point returns the first cudaGetLastError() that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kReduceThreads = 1024;
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// The 2×2-tap geometry of one output pixel (y, x).
struct Taps {
  int64_t o00, o01, o10, o11;
  float wy0, wy1, wx0, wx1;
};

__device__ __forceinline__ Taps make_taps(const int* row_idx, const float* row_wt,
                                          const int* col_idx, const float* col_wt,
                                          int y, int x, int h_out, int w_out,
                                          int w_in) {
  const int y0 = row_idx[y], y1 = row_idx[h_out + y];
  const int x0 = col_idx[x], x1 = col_idx[w_out + x];
  Taps t;
  t.wy0 = row_wt[y];
  t.wy1 = row_wt[h_out + y];
  t.wx0 = col_wt[x];
  t.wx1 = col_wt[w_out + x];
  t.o00 = static_cast<int64_t>(y0) * w_in + x0;
  t.o01 = static_cast<int64_t>(y0) * w_in + x1;
  t.o10 = static_cast<int64_t>(y1) * w_in + x0;
  t.o11 = static_cast<int64_t>(y1) * w_in + x1;
  return t;
}

template <typename T>
__device__ __forceinline__ float interp(const T* plane, const Taps& t) {
  const float left = lerp2(t.wy0, load_f32(plane + t.o00), t.wy1, load_f32(plane + t.o10));
  const float right = lerp2(t.wy0, load_f32(plane + t.o01), t.wy1, load_f32(plane + t.o11));
  return lerp2(t.wx0, left, t.wx1, right);
}

// Max and Σexp(v − max) over the C classes of one head at one pixel.
template <typename T>
__device__ __forceinline__ void head_stats(const T* base, int64_t plane, int c,
                                           const Taps& t, float* m_out,
                                           float* s_out) {
  float m = interp(base, t);
  for (int k = 1; k < c; ++k) m = fmaxf(m, interp(base + k * plane, t));
  float s = 0.0f;
  for (int k = 0; k < c; ++k) s = __fadd_rn(s, expf(__fsub_rn(interp(base + k * plane, t), m)));
  *m_out = m;
  *s_out = s;
}

template <typename T>
__global__ void ce_fwd_kernel(const T* __restrict__ x_main, const T* __restrict__ x_aux,
                              int nheads, const int* __restrict__ labels,
                              const int* __restrict__ row_idx, const float* __restrict__ row_wt,
                              const int* __restrict__ col_idx, const float* __restrict__ col_wt,
                              float* __restrict__ part_sums, int* __restrict__ part_cnt,
                              int n, int c, int h_in, int w_in, int h_out, int w_out,
                              int ignore) {
  __shared__ float s_loss[2][kFwdThreads];
  __shared__ int s_cnt[kFwdThreads];
  const int64_t total = static_cast<int64_t>(n) * h_out * w_out;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float loss[2] = {0.0f, 0.0f};
  int valid = 0;
  if (p < total) {
    const int label = labels[p];
    if (label != ignore) {
      valid = 1;
      const int x = static_cast<int>(p % w_out);
      const int64_t r = p / w_out;
      const int y = static_cast<int>(r % h_out);
      const int b = static_cast<int>(r / h_out);
      const Taps t = make_taps(row_idx, row_wt, col_idx, col_wt, y, x, h_out, w_out, w_in);
      const int64_t plane = static_cast<int64_t>(h_in) * w_in;
      for (int head = 0; head < nheads; ++head) {
        const T* base = (head == 0 ? x_main : x_aux) + static_cast<int64_t>(b) * c * plane;
        float m, s;
        head_stats(base, plane, c, t, &m, &s);
        const float picked = (label >= 0 && label < c) ? interp(base + label * plane, t) : 0.0f;
        loss[head] = __fsub_rn(__fadd_rn(m, logf(s)), picked);
      }
    }
  }
  s_loss[0][threadIdx.x] = loss[0];
  s_loss[1][threadIdx.x] = loss[1];
  s_cnt[threadIdx.x] = valid;
  __syncthreads();
  for (int stride = kFwdThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_loss[0][threadIdx.x] = __fadd_rn(s_loss[0][threadIdx.x], s_loss[0][threadIdx.x + stride]);
      s_loss[1][threadIdx.x] = __fadd_rn(s_loss[1][threadIdx.x], s_loss[1][threadIdx.x + stride]);
      s_cnt[threadIdx.x] += s_cnt[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    part_sums[2 * blockIdx.x] = s_loss[0][0];
    part_sums[2 * blockIdx.x + 1] = s_loss[1][0];
    part_cnt[blockIdx.x] = s_cnt[0];
  }
}

// One block: fixed-order reduction of the per-block partials, then the loss.
// out_sums (2,) f32, out_cnt (1,) int32, out_loss (1,) f32.
__global__ void ce_reduce_kernel(const float* __restrict__ part_sums,
                                 const int* __restrict__ part_cnt, int nparts, int nheads,
                                 float dsn_weight, float* __restrict__ out_sums,
                                 int* __restrict__ out_cnt, float* __restrict__ out_loss) {
  __shared__ float s_loss[2][kReduceThreads];
  __shared__ int s_cnt[kReduceThreads];
  float l0 = 0.0f, l1 = 0.0f;
  int cnt = 0;
  for (int i = threadIdx.x; i < nparts; i += kReduceThreads) {
    l0 = __fadd_rn(l0, part_sums[2 * i]);
    l1 = __fadd_rn(l1, part_sums[2 * i + 1]);
    cnt += part_cnt[i];
  }
  s_loss[0][threadIdx.x] = l0;
  s_loss[1][threadIdx.x] = l1;
  s_cnt[threadIdx.x] = cnt;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_loss[0][threadIdx.x] = __fadd_rn(s_loss[0][threadIdx.x], s_loss[0][threadIdx.x + stride]);
      s_loss[1][threadIdx.x] = __fadd_rn(s_loss[1][threadIdx.x], s_loss[1][threadIdx.x + stride]);
      s_cnt[threadIdx.x] += s_cnt[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float denom = static_cast<float>(max(s_cnt[0], 1));
    float loss = __fdiv_rn(s_loss[0][0], denom);
    if (nheads == 2) loss = __fadd_rn(loss, __fmul_rn(dsn_weight, __fdiv_rn(s_loss[1][0], denom)));
    out_sums[0] = s_loss[0][0];
    out_sums[1] = s_loss[1][0];
    out_cnt[0] = s_cnt[0];
    out_loss[0] = loss;
  }
}

// Backward (a): block (y, b) of one high-res row. Shared memory: per pixel
// the max and Σexp of each head and the label (−1 where ignored), then a
// (ck, w_out) chunk of d_up. Writes tmp (n, nheads·c, h_out, w_in) f32.
template <typename T>
__global__ void ce_bwd_rows_kernel(const T* __restrict__ x_main, const T* __restrict__ x_aux,
                                   int nheads, const int* __restrict__ labels,
                                   const int* __restrict__ row_idx, const float* __restrict__ row_wt,
                                   const int* __restrict__ col_idx, const float* __restrict__ col_wt,
                                   const int* __restrict__ col_start, const int* __restrict__ col_end,
                                   const float* __restrict__ grad, const int* __restrict__ count,
                                   float dsn_weight, float* __restrict__ tmp, int c, int h_in,
                                   int w_in, int h_out, int w_out, int ignore, int ck) {
  extern __shared__ float smem[];
  float* s_max = smem;                                   // (2, w_out)
  float* s_sum = s_max + 2 * w_out;                      // (2, w_out)
  int* s_label = reinterpret_cast<int*>(s_sum + 2 * w_out);  // (w_out,)
  float* s_dup = reinterpret_cast<float*>(s_label + w_out);  // (ck, w_out)

  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int c_all = nheads * c;
  const int64_t plane = static_cast<int64_t>(h_in) * w_in;
  const float g_over_n = __fdiv_rn(grad[0], static_cast<float>(max(count[0], 1)));
  const float scale[2] = {g_over_n, __fmul_rn(g_over_n, dsn_weight)};
  const int* lab_row = labels + (static_cast<int64_t>(b) * h_out + y) * w_out;

  for (int x = threadIdx.x; x < w_out; x += blockDim.x) {
    const int label = lab_row[x];
    s_label[x] = label == ignore ? -1 : label;
    if (label == ignore) continue;
    const Taps t = make_taps(row_idx, row_wt, col_idx, col_wt, y, x, h_out, w_out, w_in);
    for (int head = 0; head < nheads; ++head) {
      const T* base = (head == 0 ? x_main : x_aux) + static_cast<int64_t>(b) * c * plane;
      head_stats(base, plane, c, t, &s_max[head * w_out + x], &s_sum[head * w_out + x]);
    }
  }
  __syncthreads();

  for (int k0 = 0; k0 < c_all; k0 += ck) {
    const int kn = min(ck, c_all - k0);
    for (int i = threadIdx.x; i < kn * w_out; i += blockDim.x) {
      const int kl = i / w_out, x = i % w_out;
      const int k = k0 + kl, head = k / c, cls = k % c;
      const int label = s_label[x];
      float d = 0.0f;
      if (label >= 0) {
        const Taps t = make_taps(row_idx, row_wt, col_idx, col_wt, y, x, h_out, w_out, w_in);
        const T* base = (head == 0 ? x_main : x_aux) + (static_cast<int64_t>(b) * c + cls) * plane;
        const float e = expf(__fsub_rn(interp(base, t), s_max[head * w_out + x]));
        const float sm = __fdiv_rn(e, s_sum[head * w_out + x]);
        d = __fmul_rn(__fsub_rn(sm, cls == label ? 1.0f : 0.0f), scale[head]);
      }
      s_dup[i] = d;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kn * w_in; i += blockDim.x) {
      const int kl = i / w_in, j = i % w_in;
      const float* row = s_dup + kl * w_out;
      float acc = 0.0f;
      for (int x = col_start[j]; x < col_end[j]; ++x) {
        float w = 0.0f;
        if (col_idx[x] == j) w = col_wt[x];
        if (col_idx[w_out + x] == j) w = __fadd_rn(w, col_wt[w_out + x]);
        acc = __fadd_rn(acc, __fmul_rn(row[x], w));
      }
      tmp[((static_cast<int64_t>(b) * c_all + k0 + kl) * h_out + y) * w_in + j] = acc;
    }
    __syncthreads();
  }
}

// Backward (b): one thread per low-res element (b, k, i, j): dX = Σ over the
// high-res rows whose taps touch row i of tmp·weight, written once in T.
template <typename T>
__global__ void ce_bwd_cols_kernel(const float* __restrict__ tmp, const int* __restrict__ row_idx,
                                   const float* __restrict__ row_wt,
                                   const int* __restrict__ row_start, const int* __restrict__ row_end,
                                   T* __restrict__ dx_main, T* __restrict__ dx_aux, int n,
                                   int nheads, int c, int h_in, int w_in, int h_out) {
  const int c_all = nheads * c;
  const int64_t total = static_cast<int64_t>(n) * c_all * h_in * w_in;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int j = static_cast<int>(p % w_in);
  int64_t r = p / w_in;
  const int i = static_cast<int>(r % h_in);
  r /= h_in;
  const int k = static_cast<int>(r % c_all);
  const int b = static_cast<int>(r / c_all);
  const float* col = tmp + (static_cast<int64_t>(b) * c_all + k) * h_out * w_in + j;
  float acc = 0.0f;
  for (int y = row_start[i]; y < row_end[i]; ++y) {
    float w = 0.0f;
    if (row_idx[y] == i) w = row_wt[y];
    if (row_idx[h_out + y] == i) w = __fadd_rn(w, row_wt[h_out + y]);
    acc = __fadd_rn(acc, __fmul_rn(col[static_cast<int64_t>(y) * w_in], w));
  }
  const int head = k / c, cls = k % c;
  T* dx = head == 0 ? dx_main : dx_aux;
  store(dx + ((static_cast<int64_t>(b) * c + cls) * h_in + i) * w_in + j, acc);
}

bool bad_shape(int n, int c, int h_in, int w_in, int h_out, int w_out, int nheads, int dtype) {
  return n <= 0 || c <= 0 || h_in <= 0 || w_in <= 0 || h_out <= 0 || w_out <= 0 ||
         (nheads != 1 && nheads != 2) || (dtype != 0 && dtype != 1);
}

}  // namespace

// Forward. dtype: 0 = float32, 1 = bfloat16. x_main/x_aux: contiguous
// (n, c, h_in, w_in) logits (x_aux unused when nheads == 1); labels (n, h_out,
// w_out) int32; part_sums (2·nparts,) f32 and part_cnt (nparts,) int32
// scratch with nparts = ceil(n·h_out·w_out / 256); out_sums (2,) f32,
// out_cnt (1,) int32, out_loss (1,) f32.
extern "C" int skd_upsampled_ce_fwd(const void* x_main, const void* x_aux, int dtype, int nheads,
                                    const void* labels, const void* row_idx, const void* row_wt,
                                    const void* col_idx, const void* col_wt, void* part_sums,
                                    void* part_cnt, void* out_sums, void* out_cnt, void* out_loss,
                                    int n, int c, int h_in, int w_in, int h_out, int w_out,
                                    int ignore, float dsn_weight, void* stream) {
  if (bad_shape(n, c, h_in, w_in, h_out, w_out, nheads, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(n) * h_out * w_out;
  const int64_t nparts = (total + kFwdThreads - 1) / kFwdThreads;
  if (nparts > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const int* ri = static_cast<const int*>(row_idx);
  const float* rw = static_cast<const float*>(row_wt);
  const int* ci = static_cast<const int*>(col_idx);
  const float* cw = static_cast<const float*>(col_wt);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_cnt);
  const unsigned blocks = static_cast<unsigned>(nparts);
  if (dtype == 0) {
    ce_fwd_kernel<float><<<blocks, kFwdThreads, 0, s>>>(
        static_cast<const float*>(x_main), static_cast<const float*>(x_aux), nheads, lab, ri, rw,
        ci, cw, ps, pc, n, c, h_in, w_in, h_out, w_out, ignore);
  } else {
    ce_fwd_kernel<__nv_bfloat16><<<blocks, kFwdThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x_main), static_cast<const __nv_bfloat16*>(x_aux),
        nheads, lab, ri, rw, ci, cw, ps, pc, n, c, h_in, w_in, h_out, w_out, ignore);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_reduce_kernel<<<1, kReduceThreads, 0, s>>>(ps, pc, static_cast<int>(nparts), nheads,
                                                dsn_weight, static_cast<float*>(out_sums),
                                                static_cast<int*>(out_cnt),
                                                static_cast<float*>(out_loss));
  return static_cast<int>(cudaGetLastError());
}

// Backward. grad (1,) f32 is the loss's incoming gradient and count (1,)
// int32 the forward's valid count, both in device memory. col_start/col_end
// (w_in,) and row_start/row_end (h_in,) int32: the high-res range whose taps
// touch each low-res column/row. tmp: (n, nheads·c, h_out, w_in) f32
// scratch. dx_main/dx_aux: contiguous (n, c, h_in, w_in) in the logits'
// dtype. ck: classes per shared-memory chunk; smem_bytes: the dynamic
// shared memory of the row kernel, (5 + ck)·w_out·4.
extern "C" int skd_upsampled_ce_bwd(const void* x_main, const void* x_aux, int dtype, int nheads,
                                    const void* labels, const void* row_idx, const void* row_wt,
                                    const void* col_idx, const void* col_wt,
                                    const void* col_start, const void* col_end,
                                    const void* row_start, const void* row_end, const void* grad,
                                    const void* count, void* tmp, void* dx_main, void* dx_aux,
                                    int n, int c, int h_in, int w_in, int h_out, int w_out,
                                    int ignore, float dsn_weight, int ck, int smem_bytes,
                                    void* stream) {
  if (bad_shape(n, c, h_in, w_in, h_out, w_out, nheads, dtype) || ck <= 0 || n > 65535 ||
      smem_bytes <= 0 || smem_bytes > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const int* ri = static_cast<const int*>(row_idx);
  const float* rw = static_cast<const float*>(row_wt);
  const int* ci = static_cast<const int*>(col_idx);
  const float* cw = static_cast<const float*>(col_wt);
  const int* cs = static_cast<const int*>(col_start);
  const int* ce = static_cast<const int*>(col_end);
  const int* rs = static_cast<const int*>(row_start);
  const int* re = static_cast<const int*>(row_end);
  const float* g = static_cast<const float*>(grad);
  const int* cnt = static_cast<const int*>(count);
  float* t = static_cast<float*>(tmp);
  const dim3 rows_grid(static_cast<unsigned>(h_out), static_cast<unsigned>(n));
  const int64_t total = static_cast<int64_t>(n) * nheads * c * h_in * w_in;
  const int64_t blocks = (total + kBwdThreads - 1) / kBwdThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    ce_bwd_rows_kernel<float><<<rows_grid, kBwdThreads, smem_bytes, s>>>(
        static_cast<const float*>(x_main), static_cast<const float*>(x_aux), nheads, lab, ri, rw,
        ci, cw, cs, ce, g, cnt, dsn_weight, t, c, h_in, w_in, h_out, w_out, ignore, ck);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ce_bwd_cols_kernel<float><<<static_cast<unsigned>(blocks), kBwdThreads, 0, s>>>(
        t, ri, rw, rs, re, static_cast<float*>(dx_main), static_cast<float*>(dx_aux), n, nheads,
        c, h_in, w_in, h_out);
  } else {
    ce_bwd_rows_kernel<__nv_bfloat16><<<rows_grid, kBwdThreads, smem_bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x_main), static_cast<const __nv_bfloat16*>(x_aux),
        nheads, lab, ri, rw, ci, cw, cs, ce, g, cnt, dsn_weight, t, c, h_in, w_in, h_out, w_out,
        ignore, ck);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ce_bwd_cols_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kBwdThreads, 0, s>>>(
        t, ri, rw, rs, re, static_cast<__nv_bfloat16*>(dx_main),
        static_cast<__nv_bfloat16*>(dx_aux), n, nheads, c, h_in, w_in, h_out);
  }
  return static_cast<int>(cudaGetLastError());
}
