// The sequential initiator combine of the walk's merge, for Hopper (sm_90a).
//
// Replaces the device lax.scan of sqmc_tpu/algo/walk.py:2090
// sequential_initiator_scan (the reference's merge_original_with_spawned2,
// do_walk.f90:5897-5950).  Over the sorted merge rows, each group (a row
// with neq set starts one) is walked in order carrying (acc_w, acc_i), the
// running weight in the walk's weight type and the running initiator:
//     same-sign pair (acc_w * w > 0)     acc_i = max(acc_i, ini)
//     otherwise                          acc_i = ini if |w| > |acc_w|,
//                                                0 if |w| == |acc_w|,
//                                                acc_i otherwise,
//                                        except that acc_i = 3 stays 3
//     then acc_w += w;
// out[i] is acc_i after row i.  At a group start the carry is the row's
// own (w, ini).  The rule is not associative, and acc_w must be summed in
// row order for its bits (and so every comparison) to be the reference's:
// the carry cannot be split.  Groups are independent, though.
//
// What bounds it: bytes.  neq, s_wt and init_row are read once and out is
// written once: 1 + 4 (8) + 4 + 4 = 13 (17) B a row, at the walk's merge
// shape (720,896 rows) 9.4 MB, 2.8 us at the H100's 3.35 TB/s.  The kernel
// is far from that whenever a group is long: the thread at a group start
// walks the whole group alone, one dependent add and select a row.
//
// Design (the simple kernel): one thread a row; the threads whose row has
// neq set walk their group.  A thread loads CHUNK rows ahead into
// registers (independent loads, in flight together), then combines them
// in order; explicit round-to-nearest products and sums keep the compiler
// from contracting them, so the bits are the plain version's.  Each row is
// written by the thread of its group: one writer a row, no atomics.
//
// Measured (chip_smoke.py phase 12e, NVIDIA H100 80GB HBM3, 700 W): 31.5
// ms a call on the HEG-14 walk's merge rows, whose empty walker and spawn
// slots share one key and so form one group of 582,030 rows that one
// thread streams alone (the bound: 2.8 us).  Zero-weight rows leave the
// running weight as it is, so a kernel that skips their runs keeps the
// bits; that is the next step (ROADMAP, K5-next).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 8;                      // rows loaded ahead a thread

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
k_seq_init(const unsigned char* __restrict__ neq, const T* __restrict__ wt,
           const int* __restrict__ ini, long long n, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n || (i > 0 && !neq[i])) return;   // row 0 always starts one
  T acc_w = wt[i];
  int acc_i = ini[i];
  out[i] = acc_i;
  for (long long base = i + 1; base < n; base += CHUNK) {
    unsigned char st[CHUNK];
    T w[CHUNK];
    int r[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const long long j = base + u;
      const bool in = j < n;
      st[u] = in ? __ldg(neq + j) : (unsigned char)1;
      w[u] = in ? __ldg(wt + j) : T(0);
      r[u] = in ? __ldg(ini + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      if (st[u]) return;                      // the next group's start
      const T a = abs_of(acc_w), b = abs_of(w[u]);
      int opp = b > a ? r[u] : (b == a ? 0 : acc_i);
      if (acc_i == 3) opp = 3;
      acc_i = mul_rn(acc_w, w[u]) > T(0) ? max(acc_i, r[u]) : opp;
      acc_w = add_rn(acc_w, w[u]);
      out[base + u] = acc_i;
    }
  }
}

template <typename T>
int launch(const void* neq, const void* wt, const void* ini, long long n,
           void* out, void* stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k_seq_init<T><<<(unsigned)blocks, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(neq), static_cast<const T*>(wt),
      static_cast<const int*>(ini), n, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sqmc_seq_init_init() { return 0; }

// neq: [n] bool (one byte a row; row 0 starts a group whatever neq[0]
// says, as in the plain version); wt: [n] float32 (f64 = 0)
// or float64 (f64 = 1); ini: [n] int32; out: [n] int32, every row written.
extern "C" int sqmc_seq_init(long long n, int f64, const void* neq,
                             const void* wt, const void* ini, void* out,
                             void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(neq, wt, ini, n, out, stream)
             : launch<float>(neq, wt, ini, n, out, stream);
}

extern "C" const char* sqmc_seq_init_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
