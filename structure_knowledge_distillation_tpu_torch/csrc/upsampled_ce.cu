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
//   backward the transpose of the interpolation, dX_k = Ahᵀ·d_k·Aw with
//            d = (softmax(up) − onehot)·mask·scale, in two passes (no float
//            atomics, every sum in a fixed order):
//            (1) one block per (image, low-res row interval, segment of
//                low-res column cells): an interval is the high-res rows
//                whose first row tap is one low-res row i, a cell the
//                high-res columns whose first column tap is one low-res
//                column j (contiguous; tables from the host), so the block
//                reads only the 2C × 2 × (cells + 1) logits it stages in
//                shared memory. Per high-res row it interpolates along H once
//                for the row, then along W once per pixel and class into
//                shared memory, forms the softmax there in the forward's
//                order, and one thread per (cell, channel) walks the cell's
//                pixels, summing d·wy·wx into the cell's four corners (rows
//                i, i+1 × columns j, j+1). It writes, per row i and i+1 of
//                the interval, the corners combined along W within the
//                segment (part, f32) and the segment's right edge (edge);
//            (2) one thread per low-res element adds row i's top sums and
//                row i−1's bottom sums, with the neighbouring segment's edge,
//                in a fixed order, and writes dX once in the logits' dtype.
//            scale = g/max(count,1) for the main head and g·w/max(count,1)
//            for the aux head, read from device memory: no host sync.
//
// What bounds it on an H100 at the train shape, (8,19,65,65)×2 logits and
// (8,512,512) labels: the forward reads 1.3 MB of logits (L2-resident) and
// 8 MB of labels and writes almost nothing, so it is bound by instruction
// issue, 2·19 four-tap interpolations per pixel done twice (max, then
// exp-sum). The backward is bound by instruction issue too: per labelled
// pixel and class one W interpolation (the H interpolation is shared by a
// row's pixels), one ex2, and four fused multiply-adds;
// its only traffic besides logits, labels and dX is part, 8·65·2·38·65·4 B =
// 10 MB, written once and read once, L2-resident. Results are bit-identical
// from run to run.
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
constexpr float kLog2e = 1.4426950408889634f;
// the H100's dynamic shared memory per block (opt-in above 48 KB)
constexpr int64_t kMaxSmemBytes = 227 * 1024;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 2^x on the special function unit (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// Backward, pass 1: block (segment s, low-res row interval i, image b). The
// interval is the high-res rows y whose first row tap is i, [row_start[i],
// row_start[i+1]); the segment is the low-res column cells [j0, j0 + nj),
// cell j being the high-res columns whose first column tap is j,
// [col_start[j], col_start[j+1]). Every pixel of the block reads only low-res
// rows i and i+1 and columns j0 .. j0 + nj, which it stages once.
//
// Per chunk of at most px_max of the segment's pixels (one chunk at the
// train shape), per high-res row y of the interval:
//   V  the staged rows interpolated along H (the forward's first step, bit
//      for bit);
//   S  one thread per (pixel, head), holding the pixel's column taps in
//      registers for all the rows and loading the next row's label ahead,
//      interpolates each class once along W into U (smem) as the forward
//      does, takes the max and Σexp(u − max) in the forward's order (exp as
//      one FMA and one ex2, a few ulps from the forward's expf), keeps
//      exp(u − max) in U and f = scale/Σexp beside it (zeros for an ignored
//      pixel), and stages the pixel's label;
//   D  one thread per (cell j, class) walks the cell's pixels in order,
//      with no branch, for both heads at once (they share the pixel's label,
//      weights and f loads): d = U·f − onehot·scale (one FMA), L += wx0·d,
//      R += wx1·d, and adds wy0·L, wy0·R, wy1·L, wy1·R to the cell's four
//      corner sums (smem).
// L goes to column j and R to column j + 1; wy0 to row i and wy1 to row i + 1.
// At the end the block writes, per channel and cell, part[b][i][t][k][j] =
// left corner of cell j + right corner of cell j − 1 (t = 0: row i, t = 1:
// row i + 1), and the right corner of its last cell to edge[b][i][t][k][s]:
// that column is the next segment's first. blockDim is kBwdThreads: at the
// train shape S takes one round and V and D two (256 threads keep 5 blocks on
// an SM; 288–352, one round each, measured slower).
template <typename T>
__global__ void ce_bwd_interval_kernel(
    const T* __restrict__ x_main, const T* __restrict__ x_aux, int nheads,
    const int* __restrict__ labels, const int* __restrict__ row_idx,
    const float* __restrict__ row_wt, const int* __restrict__ col_idx,
    const float* __restrict__ col_wt, const int* __restrict__ row_start,
    const int* __restrict__ col_start, const float* __restrict__ grad,
    const int* __restrict__ count, float dsn_weight, float* __restrict__ part,
    float* __restrict__ edge, int c, int h_in, int w_in, int h_out, int w_out, int ignore,
    int seg, int px_max) {
  extern __shared__ float smem[];
  const int nseg = (w_in + seg - 1) / seg;
  const int s = blockIdx.x % nseg;
  const int i = blockIdx.x / nseg;
  const int b = blockIdx.y;
  const int c2 = nheads * c;
  const int j0 = s * seg;
  const int nj = min(seg, w_in - j0);
  const int ncols = min(nj + 1, w_in - j0);  // staged columns j0 .. j0 + ncols − 1
  const int ustride = c2 | 1;                // odd: no bank conflict across pixels
  float2* s_wx = reinterpret_cast<float2*>(smem);  // (px_max,) column weights per pixel
  float2* s_f = s_wx + px_max;               // (px_max,) scale/Σexp of each head per pixel
  int* s_lab = reinterpret_cast<int*>(s_f + px_max);  // (px_max,) −1: ignored
  int2* s_rng = reinterpret_cast<int2*>(s_lab + px_max + (px_max & 1));  // (seg,) cell pixels
  float* xs = reinterpret_cast<float*>(s_rng + seg);  // (2, c2, ncols) rows i, i + 1
  float* v = xs + 2 * c2 * ncols;            // (c2, ncols) rows interpolated along H
  float* u = v + c2 * ncols;                 // (px_max, ustride) exp(u − max) per pixel
  float* acc = u + px_max * ustride;         // (4, nj, c2) corner sums TL TR BL BR

  const float scale_main = __fdiv_rn(grad[0], static_cast<float>(max(count[0], 1)));
  const float scale_aux = __fmul_rn(scale_main, dsn_weight);
  const int y_begin = row_start[i], y_end = row_start[i + 1];
  const int xa = col_start[j0], xb = col_start[j0 + nj];

  for (int q = threadIdx.x; q < 4 * nj * c2; q += blockDim.x) acc[q] = 0.0f;
  if (y_begin < y_end) {
    const int64_t plane = static_cast<int64_t>(h_in) * w_in;
    for (int q = threadIdx.x; q < 2 * c2 * ncols; q += blockDim.x) {
      const int jj = q % ncols, k = (q / ncols) % c2, r = q / (ncols * c2);
      const int row = r == 0 ? i : min(i + 1, h_in - 1);
      const T* base = k < c ? x_main : x_aux;
      const int cls = k < c ? k : k - c;
      xs[q] = load_f32(base + (static_cast<int64_t>(b) * c + cls) * plane +
                       static_cast<int64_t>(row) * w_in + j0 + jj);
    }
  }
  __syncthreads();

  const int* lab_img = labels + static_cast<int64_t>(b) * h_out * w_out;
  for (int p = xa; p < xb && y_begin < y_end; p += px_max) {
    const int npx = min(px_max, xb - p);
    // S's thread for (pixel, head) of this chunk (kBwdThreads ≥ nheads·px_max)
    const bool s_active = threadIdx.x < nheads * npx;
    const int head = s_active ? threadIdx.x / npx : 0;
    const int px_s = s_active ? threadIdx.x % npx : 0;
    const int x = p + px_s;
    const int lo = col_idx[x] - j0, hi = col_idx[w_out + x] - j0;
    const float wx0 = col_wt[x], wx1 = col_wt[w_out + x];
    int label_next = s_active ? lab_img[static_cast<int64_t>(y_begin) * w_out + x] : ignore;
    if (s_active && head == 0) s_wx[px_s] = make_float2(wx0, wx1);
    for (int jj = threadIdx.x; jj < nj; jj += blockDim.x) {
      s_rng[jj] = make_int2(max(col_start[j0 + jj], p) - p,
                            min(col_start[j0 + jj + 1], p + npx) - p);
    }

    // the row's weights, second tap and label, loaded one row ahead
    float wy0_next = row_wt[y_begin], wy1_next = row_wt[h_out + y_begin];
    int hi_next = row_idx[h_out + y_begin];
    for (int y = y_begin; y < y_end; ++y) {
      const float wy0 = wy0_next, wy1 = wy1_next;
      const int hi_off = hi_next == i ? 0 : c2 * ncols;
      const int label = label_next;
      if (y + 1 < y_end) {
        wy0_next = row_wt[y + 1];
        wy1_next = row_wt[h_out + y + 1];
        hi_next = row_idx[h_out + y + 1];
        if (s_active) label_next = lab_img[static_cast<int64_t>(y + 1) * w_out + x];
      }
      // V: one thread per (class, column) for both heads
      for (int q = threadIdx.x; q < c * ncols; q += blockDim.x) {
        for (int h = 0, k = q; h < nheads; ++h, k += c * ncols) {
          v[k] = lerp2(wy0, xs[k], wy1, xs[hi_off + k]);
        }
      }
      __syncthreads();
      // S: exp(u − max) and scale/Σexp of each head at each pixel; an
      // ignored pixel gets zeros, so D adds exact zeros for it
      if (s_active) {
        if (head == 0) s_lab[px_s] = label == ignore ? -1 : (label >= 0 && label < c ? label : c);
        float* uh = u + px_s * ustride + head * c;
        float f = 0.0f;
        if (label != ignore) {
          const float* vh = v + head * c * ncols;
          float m = 0.0f;
#pragma unroll 4
          for (int k = 0; k < c; ++k) {
            const float val = lerp2(wx0, vh[k * ncols + lo], wx1, vh[k * ncols + hi]);
            uh[k] = val;
            m = k == 0 ? val : fmaxf(m, val);
          }
          // exp(u − m) as 2^(u·log2e − m·log2e): one FMA and one ex2
          const float m2 = __fmul_rn(m, kLog2e);
          float sum = 0.0f;
#pragma unroll 4
          for (int k = 0; k < c; ++k) {
            const float e = ex2(__fmaf_rn(uh[k], kLog2e, -m2));
            uh[k] = e;
            sum = __fadd_rn(sum, e);
          }
          f = __fmul_rn(__frcp_rn(sum), head == 0 ? scale_main : scale_aux);
        } else {
          for (int k = 0; k < c; ++k) uh[k] = 0.0f;
        }
        reinterpret_cast<float*>(s_f)[2 * px_s + head] = f;
      }
      __syncthreads();
      // D: the row's part of each cell's corner sums, both heads at once
      for (int q = threadIdx.x; q < nj * c; q += blockDim.x) {
        const int jj = q / c, cls = q % c;
        const int2 rng = s_rng[jj];
        if (rng.x >= rng.y) continue;
        float l0 = 0.0f, r0 = 0.0f, l1 = 0.0f, r1 = 0.0f;
#pragma unroll 4
        for (int px = rng.x; px < rng.y; ++px) {
          const float2 wx = s_wx[px], f = s_f[px];
          const bool hit = s_lab[px] == cls;
          const float* up = u + px * ustride + cls;
          const float d0 = fmaf(up[0], f.x, hit ? -scale_main : 0.0f);
          l0 = fmaf(wx.x, d0, l0);
          r0 = fmaf(wx.y, d0, r0);
          if (nheads == 2) {
            const float d1 = fmaf(up[c], f.y, hit ? -scale_aux : 0.0f);
            l1 = fmaf(wx.x, d1, l1);
            r1 = fmaf(wx.y, d1, r1);
          }
        }
        float* a = acc + jj * c2 + cls;
        const int corner = nj * c2;
        a[0] = fmaf(wy0, l0, a[0]);
        a[corner] = fmaf(wy0, r0, a[corner]);
        a[2 * corner] = fmaf(wy1, l0, a[2 * corner]);
        a[3 * corner] = fmaf(wy1, r0, a[3 * corner]);
        if (nheads == 2) {
          a[c] = fmaf(wy0, l1, a[c]);
          a[corner + c] = fmaf(wy0, r1, a[corner + c]);
          a[2 * corner + c] = fmaf(wy1, l1, a[2 * corner + c]);
          a[3 * corner + c] = fmaf(wy1, r1, a[3 * corner + c]);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // part[b][i][t][k][j0 + jj] and edge[b][i][t][k][s]
  const int64_t bi = static_cast<int64_t>(b) * h_in + i;
  for (int q = threadIdx.x; q < 2 * c2 * nj; q += blockDim.x) {
    const int jj = q % nj, k = (q / nj) % c2, t = q / (nj * c2);
    const float* left = acc + 2 * t * nj * c2;
    const float* right = left + nj * c2;
    float val = left[jj * c2 + k];
    if (jj > 0) val = __fadd_rn(val, right[(jj - 1) * c2 + k]);
    const int64_t tk = (bi * 2 + t) * c2 + k;
    part[tk * w_in + j0 + jj] = val;
    if (jj == nj - 1) edge[tk * nseg + s] = right[jj * c2 + k];
  }
}

// Backward, pass 2: block (plane (b, k) of the two heads, 256 elements of
// the plane), one thread per low-res element (i, j): dX = row i's top sums +
// row i − 1's bottom sums, each with the previous segment's right edge where
// j starts a segment, added in that fixed order and written once in T.
template <typename T>
__global__ void ce_bwd_combine_kernel(const float* __restrict__ part,
                                      const float* __restrict__ edge, T* __restrict__ dx_main,
                                      T* __restrict__ dx_aux, int nheads, int c, int h_in,
                                      int w_in, int seg) {
  const int c2 = nheads * c;
  const int nseg = (w_in + seg - 1) / seg;
  const int k = blockIdx.x % c2, b = blockIdx.x / c2;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= h_in * w_in) return;
  const int i = p / w_in, j = p - i * w_in;
  const bool seg_start = j > 0 && j % seg == 0;
  const int64_t top = (static_cast<int64_t>(b) * h_in + i) * 2 * c2 + k;
  float acc = part[top * w_in + j];
  if (seg_start) acc = __fadd_rn(acc, edge[top * nseg + j / seg - 1]);
  if (i > 0) {
    const int64_t bot = ((static_cast<int64_t>(b) * h_in + i - 1) * 2 + 1) * c2 + k;
    acc = __fadd_rn(acc, part[bot * w_in + j]);
    if (seg_start) acc = __fadd_rn(acc, edge[bot * nseg + j / seg - 1]);
  }
  const int cls = k < c ? k : k - c;
  T* dx = k < c ? dx_main : dx_aux;
  store(dx + (static_cast<int64_t>(b) * c + cls) * h_in * w_in + p, acc);
}

// The pass-1 kernel's dynamic shared memory for `seg` cells and chunks of
// `px_max` pixels, in bytes (ops/upsampled_ce.py::_bwd_tiling mirrors it).
int64_t bwd_smem_bytes(int c2, int w_in, int seg, int px_max) {
  const int64_t nj = seg < w_in ? seg : w_in;
  const int64_t ncols = seg + 1 < w_in ? seg + 1 : w_in;
  return 4 * (3 * c2 * ncols + static_cast<int64_t>(px_max) * (c2 | 1) + 4 * nj * c2 +
              5 * static_cast<int64_t>(px_max) + (px_max & 1) + 2 * static_cast<int64_t>(seg));
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
// int32 the forward's valid count, both in device memory. row_start (h_in+1,)
// and col_start (w_in+1,) int32: the high-res rows/columns whose first tap is
// each low-res row/column, [start[j], start[j+1]). part (n, h_in, 2,
// nheads·c, w_in) and edge (n, h_in, 2, nheads·c, ceil(w_in/seg)) f32
// scratch. dx_main/dx_aux: contiguous (n, c, h_in, w_in) in the logits'
// dtype. seg: low-res columns per block; px_max: pixels per chunk, at most
// kBwdThreads/nheads (one thread per (pixel, head) of a chunk);
// smem_bytes: the pass-1 kernel's dynamic shared memory (bwd_smem_bytes),
// at most 227 KB (opted in above 48 KB).
extern "C" int skd_upsampled_ce_bwd(const void* x_main, const void* x_aux, int dtype, int nheads,
                                    const void* labels, const void* row_idx, const void* row_wt,
                                    const void* col_idx, const void* col_wt,
                                    const void* row_start, const void* col_start,
                                    const void* grad, const void* count, void* part, void* edge,
                                    void* dx_main, void* dx_aux, int n, int c, int h_in,
                                    int w_in, int h_out, int w_out, int ignore, float dsn_weight,
                                    int seg, int px_max, int smem_bytes, void* stream) {
  if (bad_shape(n, c, h_in, w_in, h_out, w_out, nheads, dtype) || n > 65535 || seg <= 0 ||
      px_max <= 0 || nheads * px_max > kBwdThreads ||
      smem_bytes != bwd_smem_bytes(nheads * c, w_in, seg, px_max) ||
      smem_bytes > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nseg = (w_in + seg - 1) / seg;
  // pass 2's grid: (n·nheads·c planes, 256-element chunks of a plane)
  const int64_t planes = static_cast<int64_t>(n) * nheads * c;
  const int64_t chunks = (static_cast<int64_t>(h_in) * w_in + kBwdThreads - 1) / kBwdThreads;
  if (nseg * h_in > 0x7fffffff || planes > 0x7fffffff || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 combine_grid(static_cast<unsigned>(planes), static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nseg * h_in), static_cast<unsigned>(n));
  const int* lab = static_cast<const int*>(labels);
  const int* ri = static_cast<const int*>(row_idx);
  const float* rw = static_cast<const float*>(row_wt);
  const int* ci = static_cast<const int*>(col_idx);
  const float* cw = static_cast<const float*>(col_wt);
  const int* rs = static_cast<const int*>(row_start);
  const int* cs = static_cast<const int*>(col_start);
  const float* g = static_cast<const float*>(grad);
  const int* cnt = static_cast<const int*>(count);
  float* pt = static_cast<float*>(part);
  float* eg = static_cast<float*>(edge);
  cudaError_t err;
  if (dtype == 0) {
    auto kernel = ce_bwd_interval_kernel<float>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem_bytes)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    kernel<<<grid, kBwdThreads, smem_bytes, s>>>(
        static_cast<const float*>(x_main), static_cast<const float*>(x_aux), nheads, lab, ri, rw,
        ci, cw, rs, cs, g, cnt, dsn_weight, pt, eg, c, h_in, w_in, h_out, w_out, ignore, seg,
        px_max);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ce_bwd_combine_kernel<float><<<combine_grid, kBwdThreads, 0, s>>>(
        pt, eg, static_cast<float*>(dx_main), static_cast<float*>(dx_aux), nheads, c, h_in, w_in,
        seg);
  } else {
    auto kernel = ce_bwd_interval_kernel<__nv_bfloat16>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem_bytes)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    kernel<<<grid, kBwdThreads, smem_bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x_main), static_cast<const __nv_bfloat16*>(x_aux),
        nheads, lab, ri, rw, ci, cw, rs, cs, g, cnt, dsn_weight, pt, eg, c, h_in, w_in, h_out,
        w_out, ignore, seg, px_max);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ce_bwd_combine_kernel<__nv_bfloat16><<<combine_grid, kBwdThreads, 0, s>>>(
        pt, eg, static_cast<__nv_bfloat16*>(dx_main), static_cast<__nv_bfloat16*>(dx_aux), nheads,
        c, h_in, w_in, seg);
  }
  return static_cast<int>(cudaGetLastError());
}
