// Slot -> parent expand of the walk's spawn slots, for Hopper (sm_90a).
//
// Replaces the TPU-shaped expand of sqmc_tpu/algo/walk.py:1444-1467: a
// scatter-max of each walker's index at its first slot plus lax.cummax,
// chosen there by v5e A/Bs (a [CAP] scatter and scan beat a sort-based
// searchsorted on the TPU).  It computes, bit for bit,
//     b = clip(cummax(scatter_max(clip(off, 0, CAP - 1), arange(M))), 0, M - 1)
// with off[i] = cum[i - 1] (0 for i = 0) the first slot of walker i and
// cum the inclusive prefix of the child counts.  For a nondecreasing cum
// (a prefix of counts >= 0) that is, at slot s < CAP - 1,
//     b[s] = #{j < M - 1 : cum[j] <= s},
// an upper-bound search over cum[0 .. M - 2]; every walker whose first
// slot is at or past CAP - 1 lands on slot CAP - 1 through the clip, so
// b[CAP - 1] = M - 1 whatever the spawn total.
//
// What bounds it: bytes.  cum is read once (8 B a walker) and b written
// once (8 B a slot): at the walk's shape (M = 458,752, CAP = 262,144)
// 5.8 MB, 1.7 us at the H100's 3.35 TB/s.
//
// Design: one thread per slot, a binary search of ~19 steps over cum.
// cum (3.7 MB) stays in the 50 MB L2 and the first steps of every search
// read the same few lines, so the searches cost L2 latency, which the
// 262,144 threads in flight hide.  Each slot has one writer; no shared
// memory.  A design where each walker writes its own run of slots would
// need no search but is as slow as its longest run, and one walker can
// own thousands.
//
// Measured (chip_smoke.py phases 2d and 2c, H100): 7.6 us of kernel time at
// the walk's shape, 4.4x the bound; torch.searchsorted of the same slots
// takes ~7.2 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
k_slot_parents(const long long* __restrict__ cum, long long m, long long cap,
               long long* __restrict__ b) {
  const long long s = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (s >= cap) return;
  long long lo = m - 1;
  if (s < cap - 1) {
    long long hi = m - 1;
    lo = 0;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (__ldg(cum + mid) <= s) lo = mid + 1; else hi = mid;
    }
  }
  b[s] = lo;
}

}  // namespace

extern "C" int sqmc_slot_parents_init() { return 0; }

// cum: [m] int64, nondecreasing and >= 0; b: [cap] int64, every entry
// written.
extern "C" int sqmc_slot_parents(long long m, long long cap, const void* cum,
                                 void* b, void* stream) {
  if (m <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (cap + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k_slot_parents<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cum), m, cap, static_cast<long long*>(b));
  return (int)cudaGetLastError();
}

extern "C" const char* sqmc_slot_parents_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
