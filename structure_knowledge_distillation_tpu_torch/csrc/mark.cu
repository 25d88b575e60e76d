// A device time stamp on a stream: the mark of `utils/spans.py::phase`.
//
// Replaces no TPU kernel. A CUDA-graph replay is one `cudaGraphLaunch` on the
// host, so no host clock and no profiler range can split its device time into
// the train step's phases. One thread of this kernel, launched on the phase's
// stream before and after the phase (and, inside a capture, recorded into the
// graph with the rest), reads the global nanosecond timer when the stream
// reaches it and writes (code, time) into a ring in device memory:
//
//   ring[0]            the cursor: marks written since it was last zeroed
//   ring[2 + 2·i]      code of entry i = phase id · 2 + (0 begin, 1 end)
//   ring[2 + 2·i + 1]  %globaltimer in ns
//
// with i = atomicAdd(cursor, 1) mod capacity, so a ring that fills keeps the
// newest `capacity` marks. The kernel is one thread and two 16-byte writes:
// its cost is the launch (a few µs on the stream, inside a graph less), far
// below the millisecond phases it brackets.
//
// Launch contract (nvcc into a shared library, loaded with ctypes): the
// kernel runs on the caller's stream, never synchronises, allocates nothing,
// and the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void skd_mark_kernel(long long* ring, int capacity, long long code) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long* cursor = reinterpret_cast<unsigned long long*>(ring);
  const unsigned long long i = atomicAdd(cursor, 1ULL) % static_cast<unsigned long long>(capacity);
  long long* entry = ring + 2 + 2 * i;
  entry[0] = code;
  entry[1] = static_cast<long long>(t);
}

}  // namespace

extern "C" int skd_mark(void* ring, int capacity, int code, void* stream) {
  if (ring == nullptr || capacity <= 0 || code < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  skd_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), capacity, static_cast<long long>(code));
  return static_cast<int>(cudaGetLastError());
}
