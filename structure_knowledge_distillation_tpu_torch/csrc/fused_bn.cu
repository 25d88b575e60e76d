// Fused activated batch norm (ABN) over NCHW tensors: the normalise + affine
// + activation forward, the per-channel gradient sums, and the input
// gradient, with the activation inverted from the saved output.
//
// Replaces the TPU kernels of structure_knowledge_distillation_tpu/ops/
// pallas_bn.py:
//   K6 `_fwd_pallas` (:73, body `_fwd_kernel` :67)            -> bn_fwd_kernel
//   K7 `_edz_eydz_pallas` (:117, body `_edz_eydz_kernel` :92) -> bn_sums_kernel
//                                                                + bn_sums_reduce_kernel
//   K8 `_bwd_pallas` (:163, body `_bwd_kernel` :143)          -> bn_bwd_kernel
//
// The Pallas kernels tile an NHWC tensor as (rows, channels) blocks, and K7
// zeroes its (1, C) outputs at grid step 0 and adds into them across a grid
// that the TPU runs in order. On the card the tensor is NCHW, so a channel is
// N planes of H·W contiguous elements, and blocks run in parallel in no
// order. So:
//
//   layout   one block row per (image, channel) plane (blockIdx.x), split
//            into chunks along H·W (blockIdx.y). The block reads its
//            channel's parameters once; the plane is read in 16-byte vectors
//            (4 f32 or 8 bf16) over its aligned body, with the unaligned
//            head and tail (H·W = 4225 at 65², not a multiple of anything)
//            done one element at a time by the plane's first chunk. The
//            wrapper passes 16-byte-aligned base pointers (it copies a view
//            that is not), so every plane's alignment follows from its
//            element offset alone.
//   K6       z = act(x·scale + shift) in f32, stored in x's dtype;
//            __fmul_rn/__fadd_rn keep nvcc from contracting to an FMA, so
//            the rounding is that of the two separate f32 operations of the
//            plain version.
//   K7       each block sums g' and g'·ŷ over its chunk (g' the incoming
//            gradient times act'(pre), ŷ = (pre − β)/γ, pre the activation
//            inverted from the saved output z) in a fixed order and writes
//            one partial per block; a second kernel, one block per channel,
//            adds the channel's partials in a fixed order. No float atomics:
//            two runs are bit-identical.
//   K8       dx = (g' − edz − ŷ·eydz)·coef (training) or g'·coef, f32 math,
//            stored in dz's dtype.
//
// What bounds it on an H100: all three are streams over device memory with
// a few flops per element. At the R101 layer4 shape (8,2048,65,65) in bf16,
// K6 reads and writes 2 B per element (139 MB), K7 reads 4 B (z and dz) and
// K8 reads 4 B and writes 2 B; at 3.35 TB/s K6 cannot take less than about
// 42 µs there. The design keeps each pass to one read of each input and one
// write of the output, with 16-byte accesses and no integer division per
// element (the channel comes from the block index).
//
// Launch contract (nvcc into a shared library, loaded with ctypes): the
// kernels run on the caller's stream, never synchronise, allocate nothing,
// and each C entry point returns the first cudaGetLastError() that is not 0.
// `threads` and `chunks` (the launch geometry) come from the wrapper and are
// checked here: chunks·threads·kVecPerThread vectors must cover a plane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVecPerThread = 4;   // 16-byte vectors per thread and chunk
constexpr int kReduceThreads = 256;
constexpr int kNone = 0, kLeaky = 1, kElu = 2;

// 16-byte vectors: 4 f32 or 8 bf16 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
};

template <typename T>
__device__ __forceinline__ typename Vec<T>::Raw load_vec(const T* p) {
  return __ldg(reinterpret_cast<const typename Vec<T>::Raw*>(p));
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const typename Vec<T>::Raw& r) {
  *reinterpret_cast<typename Vec<T>::Raw*>(p) = r;
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// The elements of one plane that a block handles: the aligned body
// [a0, a1) in vectors [v_lo, v_hi), and, for the plane's first chunk only,
// the scalar head [start, a0) and tail [a1, end). Indices are global.
struct Span {
  int64_t start, end, a0, a1, v_lo, v_hi;
  bool scalars;
};

template <int V>
__device__ __forceinline__ Span plane_span(int64_t hw) {
  Span s;
  s.start = static_cast<int64_t>(blockIdx.x) * hw;
  s.end = s.start + hw;
  s.a0 = min64(s.end, (s.start + V - 1) / V * V);
  s.a1 = max64(s.a0, s.end / V * V);
  const int64_t nvec = (s.a1 - s.a0) / V;
  const int64_t per_block = static_cast<int64_t>(blockDim.x) * kVecPerThread;
  s.v_lo = min64(nvec, static_cast<int64_t>(blockIdx.y) * per_block);
  s.v_hi = min64(nvec, s.v_lo + per_block);
  s.scalars = blockIdx.y == 0;
  return s;
}

// Scalar index i in [0, head + tail) -> the global element index.
__device__ __forceinline__ int64_t edge_index(const Span& s, int64_t i) {
  const int64_t head = s.a0 - s.start;
  return i < head ? s.start + i : s.a1 + (i - head);
}

__device__ __forceinline__ int64_t edge_count(const Span& s) {
  return (s.a0 - s.start) + (s.end - s.a1);
}

template <int ACT>
__device__ __forceinline__ float act_fwd(float h, float slope) {
  if (ACT == kLeaky) return h >= 0.0f ? h : __fmul_rn(h, slope);
  if (ACT == kElu) return h >= 0.0f ? h : expm1f(h);
  return h;
}

// The activation inverted from its output z (pallas_bn.py:104-111): the
// pre-activation, and the incoming gradient g times act'(pre).
template <int ACT>
__device__ __forceinline__ float act_inverse(float z, float slope, float* g) {
  if (ACT == kLeaky && !(z >= 0.0f)) {
    *g = __fmul_rn(*g, slope);
    return __fdiv_rn(z, slope);
  }
  if (ACT == kElu && !(z >= 0.0f)) {
    *g = __fmul_rn(*g, __fadd_rn(z, 1.0f));
    return log1pf(z);
  }
  return z;
}

// ------------------------------------------------------------------ K6
template <typename T, int ACT>
__global__ void bn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                              const float* __restrict__ shift, T* __restrict__ z, int c,
                              int64_t hw, float slope) {
  constexpr int V = Vec<T>::kN;
  const int ch = static_cast<int>(blockIdx.x % static_cast<unsigned>(c));
  const float sc = scale[ch], sh = shift[ch];
  const Span s = plane_span<V>(hw);
  for (int64_t v = s.v_lo + threadIdx.x; v < s.v_hi; v += blockDim.x) {
    const int64_t i = s.a0 + v * V;
    float f[V];
    Vec<T>::unpack(load_vec(x + i), f);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = act_fwd<ACT>(__fadd_rn(__fmul_rn(f[k], sc), sh), slope);
    store_vec(z + i, Vec<T>::pack(f));
  }
  if (s.scalars) {
    for (int64_t e = threadIdx.x; e < edge_count(s); e += blockDim.x) {
      const int64_t i = edge_index(s, e);
      store(z + i, act_fwd<ACT>(__fadd_rn(__fmul_rn(load_f32(x + i), sc), sh), slope));
    }
  }
}

// ------------------------------------------------------------------ K7
// Fixed-order block sum of two values; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float* a, float* b) {
  __shared__ float s_a[32], s_b[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    *a = __fadd_rn(*a, __shfl_down_sync(0xffffffffu, *a, off));
    *b = __fadd_rn(*b, __shfl_down_sync(0xffffffffu, *b, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_a[warp] = *a;
    s_b[warp] = *b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = s_a[0], tb = s_b[0];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) {
      ta = __fadd_rn(ta, s_a[w]);
      tb = __fadd_rn(tb, s_b[w]);
    }
    *a = ta;
    *b = tb;
  }
}

template <int ACT>
__device__ __forceinline__ void accumulate(float zv, float gv, float beta, float gamma,
                                           float slope, float* sg, float* sgy) {
  const float pre = act_inverse<ACT>(zv, slope, &gv);
  const float y = __fdiv_rn(__fsub_rn(pre, beta), gamma);
  *sg = __fadd_rn(*sg, gv);
  *sgy = __fadd_rn(*sgy, __fmul_rn(gv, y));
}

// partials: (2, c, n·chunks) f32, the plane's chunk at column
// (blockIdx.x / c)·chunks + blockIdx.y.
template <typename T, int ACT>
__global__ void bn_sums_kernel(const T* __restrict__ z, const T* __restrict__ dz,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               float* __restrict__ partials, int n, int c, int64_t hw,
                               float slope) {
  constexpr int V = Vec<T>::kN;
  const int ch = static_cast<int>(blockIdx.x % static_cast<unsigned>(c));
  const int img = static_cast<int>(blockIdx.x / static_cast<unsigned>(c));
  const float gm = gamma[ch], bt = beta[ch];
  const Span s = plane_span<V>(hw);
  float sg = 0.0f, sgy = 0.0f;
  for (int64_t v = s.v_lo + threadIdx.x; v < s.v_hi; v += blockDim.x) {
    const int64_t i = s.a0 + v * V;
    float fz[V], fg[V];
    Vec<T>::unpack(load_vec(z + i), fz);
    Vec<T>::unpack(load_vec(dz + i), fg);
#pragma unroll
    for (int k = 0; k < V; ++k) accumulate<ACT>(fz[k], fg[k], bt, gm, slope, &sg, &sgy);
  }
  if (s.scalars) {
    for (int64_t e = threadIdx.x; e < edge_count(s); e += blockDim.x) {
      const int64_t i = edge_index(s, e);
      accumulate<ACT>(load_f32(z + i), load_f32(dz + i), bt, gm, slope, &sg, &sgy);
    }
  }
  block_sum2(&sg, &sgy);
  if (threadIdx.x == 0) {
    const int64_t parts = static_cast<int64_t>(n) * gridDim.y;
    const int64_t col = static_cast<int64_t>(img) * gridDim.y + blockIdx.y;
    partials[static_cast<int64_t>(ch) * parts + col] = sg;
    partials[(static_cast<int64_t>(c) + ch) * parts + col] = sgy;
  }
}

// One block per channel: the channel's partials in a fixed order.
__global__ void bn_sums_reduce_kernel(const float* __restrict__ partials, int c, int64_t parts,
                                      float* __restrict__ sum_g, float* __restrict__ sum_gy) {
  const int ch = blockIdx.x;
  const float* pg = partials + static_cast<int64_t>(ch) * parts;
  const float* pgy = partials + (static_cast<int64_t>(c) + ch) * parts;
  float sg = 0.0f, sgy = 0.0f;
  for (int64_t j = threadIdx.x; j < parts; j += blockDim.x) {
    sg = __fadd_rn(sg, pg[j]);
    sgy = __fadd_rn(sgy, pgy[j]);
  }
  block_sum2(&sg, &sgy);
  if (threadIdx.x == 0) {
    sum_g[ch] = sg;
    sum_gy[ch] = sgy;
  }
}

// ------------------------------------------------------------------ K8
struct BwdParams {
  float gamma, beta, coef, edz, eydz;
};

template <int ACT, bool TRAINING>
__device__ __forceinline__ float bwd_value(float zv, float gv, const BwdParams& p, float slope) {
  const float pre = act_inverse<ACT>(zv, slope, &gv);
  if (!TRAINING) return __fmul_rn(gv, p.coef);
  const float y = __fdiv_rn(__fsub_rn(pre, p.beta), p.gamma);
  return __fmul_rn(__fsub_rn(__fsub_rn(gv, p.edz), __fmul_rn(y, p.eydz)), p.coef);
}

template <typename T, int ACT, bool TRAINING>
__global__ void bn_bwd_kernel(const T* __restrict__ z, const T* __restrict__ dz,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              const float* __restrict__ coef, const float* __restrict__ edz,
                              const float* __restrict__ eydz, T* __restrict__ dx, int c,
                              int64_t hw, float slope) {
  constexpr int V = Vec<T>::kN;
  const int ch = static_cast<int>(blockIdx.x % static_cast<unsigned>(c));
  const BwdParams p{gamma[ch], beta[ch], coef[ch], edz[ch], eydz[ch]};
  const Span s = plane_span<V>(hw);
  for (int64_t v = s.v_lo + threadIdx.x; v < s.v_hi; v += blockDim.x) {
    const int64_t i = s.a0 + v * V;
    float fz[V], fg[V];
    Vec<T>::unpack(load_vec(z + i), fz);
    Vec<T>::unpack(load_vec(dz + i), fg);
#pragma unroll
    for (int k = 0; k < V; ++k) fg[k] = bwd_value<ACT, TRAINING>(fz[k], fg[k], p, slope);
    store_vec(dx + i, Vec<T>::pack(fg));
  }
  if (s.scalars) {
    for (int64_t e = threadIdx.x; e < edge_count(s); e += blockDim.x) {
      const int64_t i = edge_index(s, e);
      store(dx + i, bwd_value<ACT, TRAINING>(load_f32(z + i), load_f32(dz + i), p, slope));
    }
  }
}

// ------------------------------------------------------------- checks
bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The launch geometry every entry point checks: a (n·c, chunks) grid of
// `threads`-thread blocks whose chunks cover a plane's vectors.
bool bad_geometry(int n, int c, int64_t hw, int dtype, int activation, int threads,
                  int chunks) {
  if (n <= 0 || c <= 0 || hw <= 0 || (dtype != 0 && dtype != 1)) return true;
  if (activation < kNone || activation > kElu) return true;
  if (threads < 32 || threads > 1024 || threads % 32 != 0) return true;
  if (chunks <= 0 || chunks > 65535) return true;
  if (static_cast<int64_t>(n) * c > 0x7fffffffLL) return true;
  const int64_t v = dtype == 0 ? 4 : 8;
  const int64_t vecs = (hw + v - 1) / v;
  return static_cast<int64_t>(chunks) * threads * kVecPerThread < vecs;
}

dim3 plane_grid(int n, int c, int chunks) {
  return dim3(static_cast<unsigned>(static_cast<int64_t>(n) * c), static_cast<unsigned>(chunks));
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale, const float* shift, void* z, int act,
                       int n, int c, int64_t hw, float slope, int threads, int chunks,
                       cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* zp = static_cast<T*>(z);
  const dim3 grid = plane_grid(n, c, chunks);
  if (act == kLeaky) {
    bn_fwd_kernel<T, kLeaky><<<grid, threads, 0, s>>>(xp, scale, shift, zp, c, hw, slope);
  } else if (act == kElu) {
    bn_fwd_kernel<T, kElu><<<grid, threads, 0, s>>>(xp, scale, shift, zp, c, hw, slope);
  } else {
    bn_fwd_kernel<T, kNone><<<grid, threads, 0, s>>>(xp, scale, shift, zp, c, hw, slope);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sums(const void* z, const void* dz, const float* gamma, const float* beta,
                        float* partials, int act, int n, int c, int64_t hw, float slope,
                        int threads, int chunks, cudaStream_t s) {
  const T* zp = static_cast<const T*>(z);
  const T* gp = static_cast<const T*>(dz);
  const dim3 grid = plane_grid(n, c, chunks);
  if (act == kLeaky) {
    bn_sums_kernel<T, kLeaky><<<grid, threads, 0, s>>>(zp, gp, gamma, beta, partials, n, c, hw,
                                                        slope);
  } else if (act == kElu) {
    bn_sums_kernel<T, kElu><<<grid, threads, 0, s>>>(zp, gp, gamma, beta, partials, n, c, hw,
                                                      slope);
  } else {
    bn_sums_kernel<T, kNone><<<grid, threads, 0, s>>>(zp, gp, gamma, beta, partials, n, c, hw,
                                                       slope);
  }
  return cudaGetLastError();
}

template <typename T, bool TRAINING>
cudaError_t launch_bwd(const void* z, const void* dz, const float* const* prm, void* dx, int act,
                       int c, const dim3& grid, int threads, int64_t hw, float slope,
                       cudaStream_t s) {
  const T* zp = static_cast<const T*>(z);
  const T* gp = static_cast<const T*>(dz);
  T* dp = static_cast<T*>(dx);
  if (act == kLeaky) {
    bn_bwd_kernel<T, kLeaky, TRAINING><<<grid, threads, 0, s>>>(
        zp, gp, prm[0], prm[1], prm[2], prm[3], prm[4], dp, c, hw, slope);
  } else if (act == kElu) {
    bn_bwd_kernel<T, kElu, TRAINING><<<grid, threads, 0, s>>>(
        zp, gp, prm[0], prm[1], prm[2], prm[3], prm[4], dp, c, hw, slope);
  } else {
    bn_bwd_kernel<T, kNone, TRAINING><<<grid, threads, 0, s>>>(
        zp, gp, prm[0], prm[1], prm[2], prm[3], prm[4], dp, c, hw, slope);
  }
  return cudaGetLastError();
}

}  // namespace

// K6. dtype: 0 = float32, 1 = bfloat16; activation: 0 none, 1 leaky_relu,
// 2 elu. x, z: contiguous (n, c, hw) in dtype, 16-byte aligned; scale,
// shift: (c,) f32.
extern "C" int skd_bn_fwd(const void* x, const void* scale, const void* shift, void* z,
                          int dtype, int activation, int n, int c, int64_t hw, float slope,
                          int threads, int chunks, void* stream) {
  if (bad_geometry(n, c, hw, dtype, activation, threads, chunks) || !aligned16(x) ||
      !aligned16(z)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const cudaError_t err =
      dtype == 0 ? launch_fwd<float>(x, sc, sh, z, activation, n, c, hw, slope, threads, chunks, s)
                 : launch_fwd<__nv_bfloat16>(x, sc, sh, z, activation, n, c, hw, slope, threads,
                                             chunks, s);
  return static_cast<int>(err);
}

// K7. z (the saved output), dz: contiguous (n, c, hw) in dtype, 16-byte
// aligned; gamma, beta: (c,) f32; partials: (2, c, n·chunks) f32 scratch;
// sum_g, sum_gy: (c,) f32 outputs, Σ g' and Σ g'·ŷ over (n, hw).
extern "C" int skd_bn_sums(const void* z, const void* dz, const void* gamma, const void* beta,
                           void* partials, void* sum_g, void* sum_gy, int dtype, int activation,
                           int n, int c, int64_t hw, float slope, int threads, int chunks,
                           void* stream) {
  if (bad_geometry(n, c, hw, dtype, activation, threads, chunks) || !aligned16(z) ||
      !aligned16(dz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* part = static_cast<float*>(partials);
  cudaError_t err =
      dtype == 0 ? launch_sums<float>(z, dz, gm, bt, part, activation, n, c, hw, slope, threads,
                                      chunks, s)
                 : launch_sums<__nv_bfloat16>(z, dz, gm, bt, part, activation, n, c, hw, slope,
                                              threads, chunks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_sums_reduce_kernel<<<c, kReduceThreads, 0, s>>>(
      part, c, static_cast<int64_t>(n) * chunks, static_cast<float*>(sum_g),
      static_cast<float*>(sum_gy));
  return static_cast<int>(cudaGetLastError());
}

// K8. z, dz, dx: contiguous (n, c, hw) in dtype, 16-byte aligned; gamma,
// beta, coef, edz, eydz: (c,) f32 (edz and eydz are the means Σ/count, read
// only when training is 1).
extern "C" int skd_bn_bwd(const void* z, const void* dz, const void* gamma, const void* beta,
                          const void* coef, const void* edz, const void* eydz, void* dx,
                          int dtype, int activation, int training, int n, int c, int64_t hw,
                          float slope, int threads, int chunks, void* stream) {
  if (bad_geometry(n, c, hw, dtype, activation, threads, chunks) || !aligned16(z) ||
      !aligned16(dz) || !aligned16(dx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* prm[5] = {static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<const float*>(coef), static_cast<const float*>(edz),
                         static_cast<const float*>(eydz)};
  const dim3 grid = plane_grid(n, c, chunks);
  cudaError_t err;
  if (dtype == 0) {
    err = training ? launch_bwd<float, true>(z, dz, prm, dx, activation, c, grid, threads, hw,
                                             slope, s)
                   : launch_bwd<float, false>(z, dz, prm, dx, activation, c, grid, threads, hw,
                                              slope, s);
  } else {
    err = training ? launch_bwd<__nv_bfloat16, true>(z, dz, prm, dx, activation, c, grid,
                                                     threads, hw, slope, s)
                   : launch_bwd<__nv_bfloat16, false>(z, dz, prm, dx, activation, c, grid,
                                                      threads, hw, slope, s);
  }
  return static_cast<int>(err);
}
