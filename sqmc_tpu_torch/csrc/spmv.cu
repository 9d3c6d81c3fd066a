// Row-pointer sparse matrix times dense block of vectors for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sqmc_tpu/ops/spmv_pallas.py:83
// `_spmv_pallas` (kernel body `_spmv_kernel`), the ELL matvec
//     y[i] = sum_k vals[i, k] * x[cols[i, k]],
// and the XLA block-ELL form the JAX package runs in production
// (`_spmv_blockell`: Davidson under device_davidson, the walk's D-space
// projection).  Both layouts are row-pointer layouts: row i owns the slots
// [row_ptr[i], row_ptr[i+1]) of flat (cols, vals) arrays -- K consecutive
// slots per row for ELL, a whole number of 128-slot blocks for block-ELL --
// so one kernel serves both.  x is [n_x, m] row-major and y [n_rows, m]:
// all m right-hand sides ride one launch (blockIdx.y picks a chunk of up
// to MC columns), replacing the JAX package's per-column loop.  float32
// inputs accumulate in float32, as K2 did; float64 inputs in float64.
//
// Design: one warp per row; the 32 lanes stride the row's slots, reading
// 8 bytes per slot (i32 col + f32 val; 12 for f64) coalesced, and gather
// x through the read-only path (__ldg); each lane keeps MC partial sums in
// registers and a warp-shuffle tree reduces them.  No atomics, so the
// result is bitwise the same on every run (Davidson stays reproducible)
// and each column's sum is taken in the same order whatever m is.
//
// What bounds it: bytes.  Every padded slot is read once (8 B in f32) plus
// the x gather (mostly L2 hits: x is 0.35 MB at C2's 88k rows), against
// 3.35 TB/s of HBM on an H100.  The C2 CAS(8e,26o) variational H (88k
// rows, 9.7M nonzeros, block-ELL about 12-14M padded slots) therefore has
// a floor of about 30-35 us per matvec.  Later: x fits in shared memory
// (227 KB, n_x <= ~56k in f32) for D spaces of that size, which would take
// the gather off L2 entirely; long rows (K_max 1347) could split across
// warps; neither is needed for a right first kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ROWS_PER_BLOCK (THREADS / 32)
#define FULL 0xffffffffu

enum { DT_F32 = 0, DT_F64 = 1 };

template <typename T, int MC>
__global__ void __launch_bounds__(THREADS)
k_spmv(long long n_rows, int m, const long long* __restrict__ row_ptr,
       const int* __restrict__ cols, const T* __restrict__ vals,
       const T* __restrict__ x, T* __restrict__ y) {
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;           // whole warps leave together
  const int c0 = blockIdx.y * MC;
  const int mc = m - c0 < MC ? m - c0 : MC;
  const long long beg = row_ptr[row], end = row_ptr[row + 1];
  T acc[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j) acc[j] = T(0);
  for (long long k = beg + lane; k < end; k += 32) {
    const int c = __ldg(cols + k);
    const T v = __ldg(vals + k);
    const T* xr = x + (size_t)c * m + c0;
#pragma unroll
    for (int j = 0; j < MC; ++j)
      if (j < mc) acc[j] += v * __ldg(xr + j);
  }
#pragma unroll
  for (int j = 0; j < MC; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(FULL, acc[j], off);
  }
  if (lane == 0) {
    T* yr = y + (size_t)row * m + c0;
#pragma unroll
    for (int j = 0; j < MC; ++j)
      if (j < mc) yr[j] = acc[j];
  }
}

template <typename T>
static cudaError_t launch(long long n_rows, int m, const long long* row_ptr,
                          const int* cols, const void* vals, const void* x,
                          void* y, cudaStream_t st) {
  const int mc = m == 1 ? 1 : (m == 2 ? 2 : (m <= 4 ? 4 : 8));
  const long long bx = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const long long by = (m + mc - 1) / mc;
  if (bx > 0x7fffffffLL || by > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)by);
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  switch (mc) {
    case 1: k_spmv<T, 1><<<grid, THREADS, 0, st>>>(n_rows, m, row_ptr, cols, v, xx, yy); break;
    case 2: k_spmv<T, 2><<<grid, THREADS, 0, st>>>(n_rows, m, row_ptr, cols, v, xx, yy); break;
    case 4: k_spmv<T, 4><<<grid, THREADS, 0, st>>>(n_rows, m, row_ptr, cols, v, xx, yy); break;
    default: k_spmv<T, 8><<<grid, THREADS, 0, st>>>(n_rows, m, row_ptr, cols, v, xx, yy); break;
  }
  return cudaGetLastError();
}

// Plain C entry point (bound with ctypes).  row_ptr: [n_rows + 1] int64;
// cols: int32 slots, each in [0, n_x); vals: slots of dtype; x: [n_x, m];
// y: [n_rows, m], every entry written.
extern "C" int sqmc_spmv(long long n_rows, int m, int dtype,
                         const void* row_ptr, const void* cols,
                         const void* vals, const void* x, void* y,
                         void* stream) {
  if (n_rows <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const long long* rp = static_cast<const long long*>(row_ptr);
  const int* c = static_cast<const int*>(cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return (int)launch<float>(n_rows, m, rp, c, vals, x, y, st);
  if (dtype == DT_F64) return (int)launch<double>(n_rows, m, rp, c, vals, x, y, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sqmc_spmv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
