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
//   forward  one block per (image, low-res row interval, window of high-res
//            columns): an interval is the high-res rows whose first row tap
//            is one low-res row i (tables from the host), so the block
//            stages rows i and i + 1 of the columns its window reads, once.
//            Per high-res row it interpolates along H once for the row
//            (height first, then width, every product and sum rounded on its
//            own as the dense f32 matmuls do), then each thread interpolates
//            each class of its pixels once along W into registers, a few
//            classes at a time, and takes the log-sum-exp and the picked
//            logit from those values, masking label == ignore. A
//            block reduces its pixels in a fixed tree; a second kernel
//            reduces the per-block partials in a fixed order and forms
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
//                shared memory, forms the softmax there (the max, then
//                Σexp), and one thread per (cell, channel) walks the cell's
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
// issue: per labelled pixel, head and class one W interpolation from a pair
// in shared memory, its max, one ex2 and the sum and pick (the H
// interpolation is shared by a row's pixels). The backward is bound by
// instruction issue too: per labelled pixel and class one W interpolation,
// one ex2, and four fused multiply-adds;
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
constexpr int kFwdPx = 2;     // forward pixels per thread: a window holds at most 512
constexpr int kFwdStage = 20;  // forward staging loads in flight per thread: the
// train shape's 2·38·65 staged values in one round
constexpr int kFwdChunk = 4;  // classes the forward holds in registers at once
constexpr int kReduceThreads = 1024;
constexpr int kBwdThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
// the H100's dynamic shared memory per block (opt-in above 48 KB)
constexpr int64_t kMaxSmemBytes = 227 * 1024;
// the forward's static shared memory: the block's reduction, 3 words a thread
constexpr int64_t kFwdStaticSmem = 3 * 4 * kFwdThreads;

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

// q / d for 0 <= q < 2^22 and d >= 1: the f32 product with 1/d is within one
// of the quotient, and one step each way corrects it
__device__ __forceinline__ int div_small(int q, int d, float inv_d) {
  int r = __float2int_rz(__fmul_rn(__int2float_rn(q), inv_d));
  r -= r * d > q;
  r += (r + 1) * d <= q;
  return r;
}

// Classes [0, KC) of vp (the first kn of them where kTail) for one pixel
// and head, interpolated once along W into registers: the running max m
// takes their max, the running sum s is rescaled to it and gains their
// 2^((u − m)·log2e), and picked takes the one at `label` if it is among them.
template <int KC, bool kTail>
__device__ __forceinline__ void lse_chunk(const float2* vp, int ncols, int kn, float wx0,
                                          float wx1, int label, float& m, float& s,
                                          float& picked) {
  float u[KC];
  float mc = m;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (kTail && k >= kn) break;
    const float2 t = vp[k * ncols];
    u[k] = lerp2(wx0, t.x, wx1, t.y);
    picked = k == label ? u[k] : picked;
    mc = fmaxf(mc, u[k]);
  }
  const float m2 = __fmul_rn(mc, kLog2e);
  s = __fmul_rn(s, ex2(__fmaf_rn(m, kLog2e, -m2)));
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (kTail && k >= kn) break;
    s = __fadd_rn(s, ex2(__fmaf_rn(u[k], kLog2e, -m2)));
  }
  m = mc;
}

// One pixel's lse − picked for one head, each class interpolated once along
// W from its pair at vp + k·ncols, kFwdChunk classes at a time (a chunk's
// max, then its exps against the new running max: one ex2 a class and one a
// chunk); the picked logit is 0 for a label outside [0, c).
__device__ __forceinline__ float pixel_loss(const float2* vp, int ncols, int c, float wx0,
                                            float wx1, int label) {
  float m = -INFINITY, s = 0.0f, picked = 0.0f;
  int k0 = 0;
  for (; k0 + kFwdChunk <= c; k0 += kFwdChunk) {
    lse_chunk<kFwdChunk, false>(vp + k0 * ncols, ncols, kFwdChunk, wx0, wx1, label - k0, m, s,
                                picked);
  }
  if (k0 < c) {
    lse_chunk<kFwdChunk, true>(vp + k0 * ncols, ncols, c - k0, wx0, wx1, label - k0, m, s,
                               picked);
  }
  return __fsub_rn(__fadd_rn(m, __logf(s)), picked);
}

// Forward: block (column window w, low-res row interval i, image b). The
// interval is the high-res rows y whose first row tap is i, [row_start[i],
// row_start[i+1]); the window is the high-res columns [w·px, (w+1)·px), whose
// column taps span the low-res columns cl .. ch, which the block stages once
// for rows i and i + 1 (ncols = ch − cl + 1 of them, at most ncols_max),
// kFwdStage loads in flight per thread.
//
// Per high-res row y of the interval:
//   V  the staged rows interpolated along H (height first, each product and
//      sum rounded on its own), once for the row, as pairs (V[col],
//      V[col + 1]) so that S reads both column taps of a class in one load;
//   S  one thread per pixel (kFwdPx of them per thread) takes its column
//      taps from registers and its label, loaded one row ahead, and adds
//      its lse − picked of each head (pixel_loss) to a register sum per
//      head, in row and pixel order. Main and aux are two calls, not one
//      loop over both heads: that spilled and ran slower on an H100.
// A pixel whose first column tap is the last staged column has no second tap
// and a second weight of exactly 0 (ops/taps.py tap_tables): the
// pair's second value there is any finite staged value, and adds 0.
// At the end a fixed tree reduces the block's sums and valid count into one
// partial per block.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads) ce_fwd_interval_kernel(
    const T* __restrict__ x_main, const T* __restrict__ x_aux, int nheads,
    const int* __restrict__ labels, const int* __restrict__ row_idx,
    const float* __restrict__ row_wt, const int* __restrict__ col_idx,
    const float* __restrict__ col_wt, const int* __restrict__ row_start,
    float* __restrict__ part_sums, int* __restrict__ part_cnt, int c, int h_in, int w_in,
    int h_out, int w_out, int ignore, int px) {
  extern __shared__ float smem[];
  __shared__ float s_loss[2][kFwdThreads];
  __shared__ int s_cnt[kFwdThreads];
  const int nwin = (w_out + px - 1) / px;
  const int win = blockIdx.x % nwin;
  const int i = blockIdx.x / nwin;
  const int b = blockIdx.y;
  const int c2 = nheads * c;
  const int x0 = win * px, x1 = min(x0 + px, w_out);
  const int cl = col_idx[x0];
  const int ncols = col_idx[w_out + x1 - 1] - cl + 1;
  const int nv = c2 * ncols;
  float* xs = smem;                                  // (2, c2, ncols) rows i, i + 1
  float2* v = reinterpret_cast<float2*>(xs + 2 * nv);  // (c2, ncols) rows along H, paired
  const int y_begin = row_start[i], y_end = row_start[i + 1];

  float loss[2] = {0.0f, 0.0f};
  int valid = 0;
  if (y_begin < y_end) {
    const int64_t plane = static_cast<int64_t>(h_in) * w_in;
    // the staged rows: element q is column q % ncols of channel row q / ncols
    const float inv_ncols = __frcp_rn(static_cast<float>(ncols));
    for (int q0 = threadIdx.x; q0 < 2 * nv; q0 += kFwdStage * kFwdThreads) {
      float val[kFwdStage];
#pragma unroll
      for (int u = 0; u < kFwdStage; ++u) {
        const int q = q0 + u * kFwdThreads;
        val[u] = 0.0f;
        if (q < 2 * nv) {
          const int rk = div_small(q, ncols, inv_ncols);
          const int r = rk < c2 ? 0 : 1, k = rk - r * c2;
          const int row = r == 0 ? i : min(i + 1, h_in - 1);
          const T* base = k < c ? x_main : x_aux;
          const int cls = k < c ? k : k - c;
          val[u] = load_f32(base + (static_cast<int64_t>(b) * c + cls) * plane +
                            static_cast<int64_t>(row) * w_in + cl + (q - rk * ncols));
        }
      }
#pragma unroll
      for (int u = 0; u < kFwdStage; ++u) {
        const int q = q0 + u * kFwdThreads;
        if (q < 2 * nv) xs[q] = val[u];
      }
    }
    // this thread's pixels: column taps in registers, labels one row ahead
    const int* lab_img = labels + static_cast<int64_t>(b) * h_out * w_out;
    bool act[kFwdPx];
    int lo[kFwdPx], label_next[kFwdPx];
    float wx0[kFwdPx], wx1[kFwdPx];
#pragma unroll
    for (int j = 0; j < kFwdPx; ++j) {
      const int x = x0 + threadIdx.x + j * kFwdThreads;
      act[j] = x < x1;
      lo[j] = act[j] ? col_idx[x] - cl : 0;
      wx0[j] = act[j] ? col_wt[x] : 0.0f;
      wx1[j] = act[j] ? col_wt[w_out + x] : 0.0f;
      label_next[j] = act[j] ? lab_img[static_cast<int64_t>(y_begin) * w_out + x] : ignore;
    }
    float wy0_next = row_wt[y_begin], wy1_next = row_wt[h_out + y_begin];
    int hi_next = row_idx[h_out + y_begin];
    float* vf = reinterpret_cast<float*>(v);
    for (int y = y_begin; y < y_end; ++y) {
      const float wy0 = wy0_next, wy1 = wy1_next;
      const int hi_off = hi_next == i ? 0 : nv;
      int label[kFwdPx];
#pragma unroll
      for (int j = 0; j < kFwdPx; ++j) label[j] = label_next[j];
      if (y + 1 < y_end) {
        wy0_next = row_wt[y + 1];
        wy1_next = row_wt[h_out + y + 1];
        hi_next = row_idx[h_out + y + 1];
#pragma unroll
        for (int j = 0; j < kFwdPx; ++j) {
          if (act[j]) {
            label_next[j] = lab_img[static_cast<int64_t>(y + 1) * w_out + x0 + threadIdx.x +
                                    j * kFwdThreads];
          }
        }
      }
      __syncthreads();  // the staging, or the previous row's S, is done
      // V: value q is the first of pair q and the second of pair q − 1
      for (int q = threadIdx.x; q < nv; q += blockDim.x) {
        const float val = lerp2(wy0, xs[q], wy1, xs[hi_off + q]);
        vf[2 * q] = val;
        if (q > 0) vf[2 * q - 1] = val;
        if (q == nv - 1) vf[2 * q + 1] = val;
      }
      __syncthreads();
      // S
#pragma unroll
      for (int j = 0; j < kFwdPx; ++j) {
        if (!act[j] || label[j] == ignore) continue;
        ++valid;
        const float2* vp = v + lo[j];
        loss[0] = __fadd_rn(loss[0], pixel_loss(vp, ncols, c, wx0[j], wx1[j], label[j]));
        if (nheads == 2) {
          loss[1] = __fadd_rn(loss[1], pixel_loss(vp + c * ncols, ncols, c, wx0[j], wx1[j],
                                                  label[j]));
        }
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
    const int64_t part = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    part_sums[2 * part] = s_loss[0][0];
    part_sums[2 * part + 1] = s_loss[1][0];
    part_cnt[part] = s_cnt[0];
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
//      interpolates each class once along W into U (smem), in the
//      forward's order, takes the max and then Σexp(u − max) (exp as one FMA and one
//      ex2; the forward's chunked sum differs by a few ulps), keeps
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

// The forward kernel's dynamic shared memory for windows that read at most
// `ncols` low-res columns: the staged rows and their pairs along H, 4·c2·ncols
// floats (ops/taps.py::window_smem_bytes mirrors it).
int64_t fwd_smem_bytes(int c2, int ncols) { return 16 * static_cast<int64_t>(c2) * ncols; }

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
// w_out) int32; row_start (h_in + 1,) int32: the high-res rows whose first
// tap is each low-res row, [start[i], start[i+1]). px: high-res columns per
// block, at most kFwdThreads·kFwdPx; ncols_max: the most low-res columns any
// window of px columns reads (ops/upsampled_ce.py::_fwd_tiling, through
// ops/taps.py::window_tiling), which sets
// the dynamic shared memory (fwd_smem_bytes, opted in above 48 KB).
// part_sums (2·nparts,) f32 and part_cnt (nparts,) int32 scratch with nparts
// = n·h_in·ceil(w_out/px); out_sums (2,) f32, out_cnt (1,) int32, out_loss
// (1,) f32.
extern "C" int skd_upsampled_ce_fwd(const void* x_main, const void* x_aux, int dtype, int nheads,
                                    const void* labels, const void* row_idx, const void* row_wt,
                                    const void* col_idx, const void* col_wt,
                                    const void* row_start, void* part_sums, void* part_cnt,
                                    void* out_sums, void* out_cnt, void* out_loss, int n, int c,
                                    int h_in, int w_in, int h_out, int w_out, int ignore,
                                    float dsn_weight, int px, int ncols_max, void* stream) {
  if (bad_shape(n, c, h_in, w_in, h_out, w_out, nheads, dtype) || n > 65535 || px <= 0 ||
      px > kFwdThreads * kFwdPx || ncols_max <= 0 || ncols_max > w_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = fwd_smem_bytes(nheads * c, ncols_max);
  const int64_t nwin = (w_out + px - 1) / px;
  const int64_t nparts = nwin * h_in * n;
  if (smem + kFwdStaticSmem > kMaxSmemBytes || nwin * h_in > 0x7fffffff ||
      nparts > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nwin * h_in), static_cast<unsigned>(n));
  const int* lab = static_cast<const int*>(labels);
  const int* ri = static_cast<const int*>(row_idx);
  const float* rw = static_cast<const float*>(row_wt);
  const int* ci = static_cast<const int*>(col_idx);
  const float* cw = static_cast<const float*>(col_wt);
  const int* rs = static_cast<const int*>(row_start);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_cnt);
  cudaError_t err;
  if (dtype == 0) {
    auto kernel = ce_fwd_interval_kernel<float>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess) {
      return static_cast<int>(err);
    }
    kernel<<<grid, kFwdThreads, smem, s>>>(
        static_cast<const float*>(x_main), static_cast<const float*>(x_aux), nheads, lab, ri, rw,
        ci, cw, rs, ps, pc, c, h_in, w_in, h_out, w_out, ignore, px);
  } else {
    auto kernel = ce_fwd_interval_kernel<__nv_bfloat16>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess) {
      return static_cast<int>(err);
    }
    kernel<<<grid, kFwdThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x_main), static_cast<const __nv_bfloat16*>(x_aux),
        nheads, lab, ri, rw, ci, cw, rs, ps, pc, c, h_in, w_in, h_out, w_out, ignore, px);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
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
