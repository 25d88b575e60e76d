// 3×3, stride-1, SAME (zero-padded) convolution with no bias, NHWC bf16
// input, bf16 weights, f32 accumulation, bf16 output: an implicit GEMM on
// Hopper's tensor cores (wgmma), fed by TMA through mbarrier rings.
//
// Replaces the TPU kernel of scripts/bench_pallas_conv.py:
//   K9 `pallas_conv3x3` (:62, body `_conv_kernel` :38), a feasibility probe
//   of a hand-written stem conv, with no caller in the package. It covers
//   one bounded set of shapes: bf16, Cin a multiple of 64, Cout 64 or 128
//   (ops/conv3x3.py routes every other case to csrc/conv3x3.cu).
//
// The Pallas kernel adds 9 shifted (rows·W, Cin)·(Cin, Cout) matmuls into a
// VMEM accumulator. That decomposition is this kernel's too:
//
//   tile     128 consecutive output pixels of one image row (b, y, x0 ...
//            x0 + 127) × all Cout channels; pixels at or past W are masked
//            on store.
//   K loop   3 steps (dy) × Cin/64 chunks per tile. A step holds the input
//            row y + dy − 1, pixels x0 − 1 ... x0 + 128 (130: the tile and a
//            one-pixel halo), 64 channels, and multiplies it for each dx by
//            that tap's (64 ch × Cout) weights: 3 (dx) × 4 (k16 slices) × 2
//            (m64 halves) wgmma.m64n{Cout}k16 into f32 registers. A fixed
//            order, no split-K, no atomics: two runs are bit-identical. One
//            rounding to bf16, in the epilogue.
//   A by TMA a 4-D tensor map on x, dims (Cin, W, H, N), box (64, 130, 1,
//            1), 128-byte swizzle (64 bf16 = 128 B, one swizzle row), loaded
//            at (c0, x0 − 1, y + dy − 1, b). The coordinates −1, W and H lie
//            outside the tensor and TMA fills them with zeros: that is the
//            SAME padding, with no masking code. Tap dx reads the box from
//            row dx on: its wgmma descriptor starts 128·dx bytes in. The
//            tensor cores apply the swizzle to the address bits, as TMA
//            does, so the shifted start needs no base offset (measured on an
//            H100: base offset (addr >> 7) & 7 reads wrong rows). One load
//            serves 3 taps, so each input row crosses L2 3 times, not 9.
//   B by TMA the wrapper repacks HWIO w (3, 3, Cin, Cout) into K-major
//            (9·Cin/64, Cout, 64), entry (dy·Cin/64 + chunk)·3 + dx
//            (ops/conv3x3.py::pack_weights), so a step's 3 taps are one (64,
//            Cout, 3) box of a 3-D tensor map, same swizzle; A and B are
//            both K-major and wgmma runs with no transpose bit. When all the
//            weights fit beside two rings of two stages (Cin·Cout ≤ 8192:
//            the probe's Cin 64), they are loaded once per block and stay
//            resident; otherwise each ring stage carries its step's weights.
//   blocks   persistent, one per SM, each walking tiles b, b + G, ... in two
//            pipes: a producer warp (one thread issues the loads) and a
//            consumer warpgroup with a ring of their own (full and empty
//            mbarriers), each pipe taking every other tile. Each ring has a
//            single consumer that waits on every use of every stage in
//            order, so mbarrier parity cannot alias (a ring shared by two
//            warpgroups that skip each other's steps lets one pass a stage
//            two phases early). The pipes take turns on the tensor cores
//            (a pair of mbarriers; pipe 0 first), so one pipe's epilogue
//            overlaps the other's products. Streamed weights leave room for
//            one pipe.
//   epilogue a transpose across each quad of lanes gives every lane 8
//            consecutive channels of one pixel, stored as one 16-byte word.
//
// What bounds it on an H100: at the probe's shape, (8,256,256,64) bf16, the
// conv is 38.7 GFLOP (Cout 64) or 77.3 GFLOP (128) against 134 or 201 MB of
// input and output: 39 or 78 µs at 989 TFLOP/s, 40 or 60 µs at 3.35 TB/s, so
// memory and compute are about balanced. With resident weights the L2 moves
// 0.2 GB of input boxes, so neither L2 nor the weights bound it. What does:
// the products alone and the loads and stores alone each take well over
// their bound, and the two overlap only in part, because a consumer
// warpgroup stalls on its own stores (PERF.md says how that was measured
// and what was tried).
//
// Launch contract (nvcc into a shared library, loaded with ctypes): the
// kernel runs on the caller's stream, never synchronises, allocates nothing,
// and the C entry point returns the first error that is not 0. The tensor
// maps are encoded on every call (the pointers change) with libcuda's
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint so that the
// library needs no -lcuda, and passed by value as __grid_constant__.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileM = 128;      // output pixels per tile
constexpr int kChunk = 64;       // input channels per K step (128 B of bf16)
constexpr int kWarpgroup = 128;  // threads
// the input box of a step: 130 pixels (the tile and a one-pixel halo on each
// side) × 64 channels, a stage rounded up to the 1024 B swizzle period
constexpr int kABox = (kTileM + 2) * kChunk * 2;
constexpr int kAStage = (kABox + 1023) / 1024 * 1024;
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one block on an H100
constexpr int kMaxStages = 8;  // per pipe

// Resident weights leave room for two pipes that overlap one tile's epilogue
// with the other's wgmma; streamed weights for one.
template <bool kResidentB>
struct Pipes {
  static constexpr int kPipes = kResidentB ? 2 : 1;
  static constexpr int kThreads = kPipes * (kWarpgroup + 32);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so a wait for parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// that TMA writes: rows of 64 bf16 (128 B), groups of 8 rows 1024 B apart
// (the stride byte offset), leading byte offset unused for this layout (1),
// layout type 1 = 128-byte swizzle, base offset 0. Every buffer starts
// 1024-byte aligned; a start a whole number of 128-byte rows in (the dx
// shift) keeps base offset 0, and the k16 slice kk starts 32·kk bytes in,
// which is +2·kk on the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions that own the registers.
template <int kN>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 × N, f32, this thread's N/2 registers) += A (64 × 16) · B (16 × N),
// A and B bf16 in shared memory, both K-major (no transpose).
template <int kN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// 4 bf16x2 words of lane q of each quad → 4 words that hold the 8 channels
// of block q: out_q[p] = in_p[q] (a 4 × 4 transpose across the quad).
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&in)[4], int lane) {
  const int q = lane & 3;
  uint32_t out[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int send = (q - r) & 3, from = (q + r) & 3;
    const uint32_t v = send == 0 ? in[0] : send == 1 ? in[1] : send == 2 ? in[2] : in[3];
    const uint32_t got = __shfl_sync(0xffffffffu, v, (lane & ~3) | from);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = from == i ? got : out[i];
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid: persistent blocks, at most one per SM. A block runs kPipes pipes,
// each a producer warp and a consumer warpgroup with a ring of its own;
// pipe p of block b takes tiles b + (p + kPipes·i)·G (G = gridDim.x; a
// tile's x fastest). Threads [0, 128·kPipes) are the consumers, the
// producer warps follow.
template <int kCout, bool kResidentB>
__global__ void __launch_bounds__(Pipes<kResidentB>::kThreads, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         __nv_bfloat16* __restrict__ out, int n, int h, int wd, int cin,
                         int stages) {
  constexpr int kPipes = Pipes<kResidentB>::kPipes;
  constexpr int kBStep = 3 * kCout * kChunk * 2;  // the weights of one step: 3 taps
  constexpr int kStageBytes = kAStage + (kResidentB ? 0 : kBStep);
  constexpr int kStageTx = kABox + (kResidentB ? 0 : kBStep);
  extern __shared__ uint8_t smem_raw[];
  const int chunks = cin / kChunk;
  const int steps = 3 * chunks;  // (dy, chunk) per tile
  const int tiles_x = (wd + kTileM - 1) / kTileM;
  const int tiles = n * h * tiles_x;
  const bool producer = threadIdx.x >= kPipes * kWarpgroup;
  const int pipe = producer ? (threadIdx.x - kPipes * kWarpgroup) / 32 : threadIdx.x / kWarpgroup;

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_all = base;  // resident weights: steps × kBStep
  const uint32_t rings = base + (kResidentB ? steps * kBStep : 0);
  const uint32_t bars = rings + kPipes * stages * kStageBytes;
  const uint32_t b_full = bars + 16 * kPipes * stages;  // the resident weights' mbarrier
  const uint32_t turn = b_full + 8;  // kPipes mbarriers: whose turn it is on the tensor cores
  const uint32_t ring = rings + pipe * stages * kStageBytes;
  const uint32_t full = bars + 16 * pipe * stages;  // stages mbarriers of this pipe
  const uint32_t empty = full + 8 * stages;         // stages mbarriers of this pipe

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * kPipes * stages; ++s) {
      // full: the producer's expect_tx arrival; empty: one per consumer warp
      mbar_init(bars + 8 * s, (s / stages) % 2 == 0 ? 1 : 4);
    }
    mbar_init(b_full, 1);
    for (int p = 0; p < kPipes; ++p) mbar_init(turn + 8 * p, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (producer) {  // one thread of the pipe's producer warp issues every load
    if (threadIdx.x % 32 == 0) {
      if constexpr (kResidentB) {
        if (pipe == 0) {
          mbar_expect_tx(b_full, steps * kBStep);
          for (int k = 0; k < steps; ++k) {
            tma_load_3d(b_all + k * kBStep, &map_w, b_full, 0, 0, 3 * k);
          }
        }
      }
      int g = 0;  // the pipe's step count, over its tiles in order
      for (int t = blockIdx.x + pipe * gridDim.x; t < tiles; t += kPipes * gridDim.x) {
        const int x0 = (t % tiles_x) * kTileM, row = t / tiles_x;
        const int y = row % h, b = row / h;
        for (int k = 0; k < steps; ++k, ++g) {
          const int s = g % stages;
          mbar_wait(empty + 8 * s, ((g / stages) & 1) ^ 1);
          const int dy = k / chunks, c0 = (k % chunks) * kChunk;
          const uint32_t st = ring + s * kStageBytes;
          mbar_expect_tx(full + 8 * s, kStageTx);
          tma_load_4d(st, &map_x, full + 8 * s, c0, x0 - 1, y + dy - 1, b);
          if constexpr (!kResidentB) tma_load_3d(st + kAStage, &map_w, full + 8 * s, 0, 0, 3 * k);
        }
      }
    }
    return;
  }

  // the pipe's consumer warpgroup: rows 0–63 of a tile into acc[0], 64–127 into acc[1]
  if constexpr (kResidentB) mbar_wait(b_full, 0);
  const int warp = (threadIdx.x % kWarpgroup) / 32, lane = threadIdx.x % 32;
  int g = 0, n_tile = 0;  // the pipe's step and tile counts
  for (int t = blockIdx.x + pipe * gridDim.x; t < tiles;
       t += kPipes * gridDim.x, ++n_tile) {
    // With two pipes, their wgmma phases take turns (pipe 0 first), so one
    // pipe's epilogue overlaps the other's products instead of both pipes
    // running in step.
    if constexpr (kPipes == 2) mbar_wait(turn + 8 * pipe, (n_tile & 1) ^ (pipe == 0));
    float acc[2][kCout / 2];
#pragma unroll
    for (int i = 0; i < kCout / 2; ++i) acc[0][i] = acc[1][i] = 0.0f;
    for (int k = 0; k < steps; ++k, ++g) {
      const int s = g % stages;
      mbar_wait(full + 8 * s, (g / stages) & 1);
      const uint32_t a = ring + s * kStageBytes;
      const uint32_t w_step = kResidentB ? b_all + k * kBStep : a + kAStage;
      fence_acc<kCout / 2>(acc[0]);
      fence_acc<kCout / 2>(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        // output pixel x0 + r reads input pixel x0 + r + dx − 1: row r + dx of
        // the box, which starts at x0 − 1. The wgmma applies the swizzle to
        // the address bits, so a start 128·dx bytes into the 1024-byte swizzle
        // period reads those rows as TMA wrote them (base offset 0).
        const uint64_t da0 = sw128_desc(a + dx * 128);
        const uint64_t da1 = sw128_desc(a + (64 + dx) * 128);
        const uint64_t db = sw128_desc(w_step + dx * kCout * 128);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          wgmma_bf16<kCout>(acc[0], da0 + 2 * kk, db + 2 * kk);
          wgmma_bf16<kCout>(acc[1], da1 + 2 * kk, db + 2 * kk);
        }
      }
      wgmma_commit();
      if constexpr (kPipes == 2) {  // the tile's last products are queued: the other pipe's turn
        if (k == steps - 1 && lane == 0) mbar_arrive(turn + 8 * (1 - pipe));
      }
      wgmma_wait<1>();  // the previous step's group is done: free its stage
      fence_acc<kCout / 2>(acc[0]);
      fence_acc<kCout / 2>(acc[1]);
      if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % stages));
    }
    wgmma_wait<0>();
    fence_acc<kCout / 2>(acc[0]);
    fence_acc<kCout / 2>(acc[1]);
    if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % stages));

    // Epilogue. In an m64nN f32 accumulator, warp w holds rows 16w ... 16w +
    // 15; for each 8-column block i, lane l holds (row l/4, columns 8i +
    // 2(l%4) + {0, 1}) in registers 4i, 4i + 1 and row l/4 + 8 in 4i + 2,
    // 4i + 3. A transpose across each quad of lanes gives lane q the 8
    // channels of block 4c + q of its row, stored as one 16-byte word; a
    // warp's store then covers 64 contiguous bytes of each of 8 pixels.
    const int x0 = (t % tiles_x) * kTileM, row = t / tiles_x;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        const int px = x0 + half * 64 + warp * 16 + lane / 4 + 8 * r8;
        uint4* o = reinterpret_cast<uint4*>(out + (static_cast<int64_t>(row) * wd + px) * kCout);
#pragma unroll
        for (int c = 0; c < kCout / 32; ++c) {
          uint32_t words[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int i = 4 * c + p;
            words[p] = pack_bf16x2(acc[half][4 * i + 2 * r8], acc[half][4 * i + 2 * r8 + 1]);
          }
          const uint4 v = quad_transpose(words, lane);
          if (px < wd) o[4 * c + (lane & 3)] = v;
        }
      }
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiledFn>(nullptr);
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Dynamic shared memory of a launch with `stages` ring stages per pipe:
// alignment slack, the resident weights, the rings, 2·stages mbarriers per
// pipe, one for the weights and two for the pipes' turns.
int smem_bytes(int resident_bytes, int stage_bytes, int pipes, int stages) {
  return 1024 + resident_bytes + pipes * stages * stage_bytes + 8 * (2 * pipes * stages + 3);
}

template <int kCout, bool kResidentB>
int launch_variant(const CUtensorMap& map_x, const CUtensorMap& map_w, __nv_bfloat16* out, int n,
                   int h, int wd, int cin, cudaStream_t stream) {
  constexpr int kBStep = 3 * kCout * kChunk * 2;
  constexpr int kPipes = Pipes<kResidentB>::kPipes;
  const int fixed = kResidentB ? 3 * (cin / kChunk) * kBStep : 0;
  const int stage_bytes = kAStage + (kResidentB ? 0 : kBStep);
  int stages = 2;
  while (stages < kMaxStages &&
         smem_bytes(fixed, stage_bytes, kPipes, stages + 1) <= kMaxSmem) {
    ++stages;
  }
  const int smem = smem_bytes(fixed, stage_bytes, kPipes, stages);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<kCout, kResidentB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>(n) * h * ((wd + kTileM - 1) / kTileM);
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  conv3x3_wgmma_kernel<kCout, kResidentB><<<grid, Pipes<kResidentB>::kThreads, smem, stream>>>(
      map_x, map_w, out, n, h, wd, cin, stages);
  return static_cast<int>(cudaGetLastError());
}

// The weights stay resident when they leave room for two pipes of two stages.
template <int kCout>
int launch(const CUtensorMap& map_x, const CUtensorMap& map_w, __nv_bfloat16* out, int n, int h,
           int wd, int cin, cudaStream_t stream) {
  const int b_bytes = 9 * (cin / kChunk) * kCout * kChunk * 2;
  return smem_bytes(b_bytes, kAStage, 2, 2) <= kMaxSmem
             ? launch_variant<kCout, true>(map_x, map_w, out, n, h, wd, cin, stream)
             : launch_variant<kCout, false>(map_x, map_w, out, n, h, wd, cin, stream);
}

}  // namespace

// x: contiguous (n, h, w, cin) bf16, 16-byte aligned; wp: contiguous
// (9·cin/64, cout, 64) bf16, the K-major repack of the HWIO weights
// (ops/conv3x3.py::pack_weights), 16-byte aligned; out: contiguous
// (n, h, w, cout) bf16. cin a multiple of 64, cout 64 or 128. Returns 0, a
// cudaError_t, or the negated CUresult of a tensor map that failed to encode.
extern "C" int skd_conv3x3_wgmma(const void* x, const void* wp, void* out, int n, int h, int wd,
                                 int cin, int cout, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cin % kChunk != 0 ||
      (cout != 64 && cout != 128) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);

  // A: dims (Cin, W, H, N) innermost first; byte strides of dims 1–3 (Cin·2
  // is a multiple of 128, so of the 16 B TMA requires); box (64, 130, 1, 1).
  CUtensorMap map_x, map_w;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(wd),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t x_strides[3] = {static_cast<cuuint64_t>(cin) * 2,
                                   static_cast<cuuint64_t>(cin) * 2 * wd,
                                   static_cast<cuuint64_t>(cin) * 2 * wd * h};
  const cuuint32_t x_box[4] = {kChunk, kTileM + 2, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), x_dims,
                      x_strides, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  // B: dims (64, Cout, 9·Cin/64), rows of 128 B; box (64, Cout, 3): the three
  // dx taps of one step.
  const cuuint64_t w_dims[3] = {kChunk, static_cast<cuuint64_t>(cout),
                                static_cast<cuuint64_t>(9 * (cin / kChunk))};
  const cuuint64_t w_strides[2] = {kChunk * 2, static_cast<cuuint64_t>(cout) * kChunk * 2};
  const cuuint32_t w_box[3] = {kChunk, static_cast<cuuint32_t>(cout), 3};
  r = encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wp), w_dims,
             w_strides, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);

  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cout == 64 ? launch<64>(map_x, map_w, o, n, h, wd, cin, s)
                    : launch<128>(map_x, map_w, o, n, h, wd, cin, s);
}
