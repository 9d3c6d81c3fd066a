// A device timestamp written where a step's work reaches it, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: it is the port's instrumentation.  The walk's
// generation runs as one replayed CUDA graph, and no host code runs inside
// a replay, so a host clock cannot split it into its pieces.  A mark is a
// one-thread kernel on the step's stream: it starts once the work queued
// before it is done, reads the device's global nanosecond clock
// (%globaltimer) and writes it, as int64 ns, at
//     buf[slot[0] * n_marks + K]
// with slot the step's device-side row index (the graph's trace row) and K
// the mark's place in the step.  K is a template argument, so every mark
// has its own kernel name in a profiler's trace (sqmc_mark<2>): the marks
// delimit the pieces on the device timeline too.
//
// What bounds it: launch and dependency latency, a few microseconds a
// mark, and 8 bytes written.  A slot outside [0, rows) writes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

template <int K>
__global__ void sqmc_mark(long long* buf, const long long* slot,
                          long long rows, int n_marks) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long r = *slot;
  if (r >= 0 && r < rows) buf[r * n_marks + K] = (long long)t;
}

extern "C" int sqmc_mark_init() { return 0; }

// buf: [rows, n_marks] int64; slot: one int64 on the device; 0 <= k <
// n_marks <= 8.
extern "C" int sqmc_mark_launch(int k, void* buf, const void* slot,
                                long long rows, int n_marks, void* stream) {
  if (k < 0 || k >= n_marks || n_marks > 8 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* b = static_cast<long long*>(buf);
  const long long* sl = static_cast<const long long*>(slot);
  switch (k) {
    case 0: sqmc_mark<0><<<1, 1, 0, s>>>(b, sl, rows, n_marks); break;
    case 1: sqmc_mark<1><<<1, 1, 0, s>>>(b, sl, rows, n_marks); break;
    case 2: sqmc_mark<2><<<1, 1, 0, s>>>(b, sl, rows, n_marks); break;
    case 3: sqmc_mark<3><<<1, 1, 0, s>>>(b, sl, rows, n_marks); break;
    case 4: sqmc_mark<4><<<1, 1, 0, s>>>(b, sl, rows, n_marks); break;
    case 5: sqmc_mark<5><<<1, 1, 0, s>>>(b, sl, rows, n_marks); break;
    case 6: sqmc_mark<6><<<1, 1, 0, s>>>(b, sl, rows, n_marks); break;
    default: sqmc_mark<7><<<1, 1, 0, s>>>(b, sl, rows, n_marks); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sqmc_mark_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
