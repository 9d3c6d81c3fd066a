// Row-pointer sparse matrix times dense block of vectors for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sqmc_tpu/ops/spmv_pallas.py:83
// `_spmv_pallas` (kernel body `_spmv_kernel`), the ELL matvec
//     y[i] = sum_k vals[i, k] * x[cols[i, k]],
// and the XLA block-ELL form the JAX package runs in production
// (`_spmv_blockell`: Davidson under device_davidson, the walk's D-space
// projection).  Both layouts are row-pointer layouts: row i starts at slot
// row_ptr[i] of flat (cols, vals) arrays -- K consecutive slots per row for
// ELL, a whole number of 128-slot blocks for block-ELL -- and holds
// row_nnz[i] real entries there, the rest being padding (column 0, value
// 0).  The kernel reads the real entries only.  x is [n_x, m] row-major
// and y [n_rows, m]: all m right-hand sides ride one launch (blockIdx.y
// picks a chunk of up to MC columns).  float32 inputs accumulate in
// float32, as K2 did; float64 inputs in float64.
//
// What bounds it: by the bytes rule, each nonzero read once (4 B column +
// 4 B value in f32, 4 + 8 in f64), the row pointers and counts (12 B a
// row), x and y: at the C2 CAS(8e,26o) shape (88,000 rows, 9,583,830
// nonzeros) 78.4 MB in f32, 23.4 us at the H100's 3.35 TB/s.  The kernel
// takes ~74 us there (chip_smoke.py phase 2c; cuSPARSE 84 us).  That
// matrix is synthetic: the C2 row lengths with uniformly random columns,
// so every lane of a warp's x gather touches its own 128-byte line.  On it
// a variant with every column folded into one line of x ran far faster,
// which suggests the gather, not the bytes, holds the kernel back there;
// whether a real C2 H, whose columns cluster, is gather-bound too is not
// known until its FCIDUMP is in the repository.
//
// Design:
//   * one warp per row (32 lanes: the fastest at the synthetic C2 rows,
//     mean ~110 entries; at HEG-14's short rows, mean ~34, 16 lanes read
//     faster, and which wins on a real C2 H is not measured);
//     each lane owns 4 consecutive slots per step, read as one 16-byte int4
//     of columns and one float4 (two double2) of values, so a warp covers
//     128 slots a step;
//   * the loop stops at the row's last real entry (row_nnz), so the
//     padding of block-ELL (up to 127 slots a row) and of ELL (K_max for
//     every row) is never read;
//   * a row that does not start on a 4-slot boundary (ELL with K % 4 != 0)
//     takes a scalar head of up to 3 slots, and the last (nnz % 4) slots a
//     scalar tail;
//   * two steps are unrolled and their column, value and x loads are
//     written before their FMAs, so a lane has 8 independent gathers in
//     flight for m = 1; for m in {2, 4} (and multiples) the m columns of an
//     x row are gathered as one vector (float2/float4, double2);
//   * the matrix streams are loaded evict-first and the kernel asks for
//     the largest L1 (it uses no shared memory; sqmc_spmv_init sets that
//     once per device), to keep x in L1;
//   * each lane keeps MC partial sums in registers and a fixed
//     shuffle tree reduces them.  No atomics: the summation order is
//     fixed, so two runs give the same bits and each column's sum is taken
//     in the same order whatever m is (m columns in one launch equal m
//     single launches bit for bit).
// The wrapper (ops/spmv.py) hands 16-byte-aligned cols, vals and x (it
// copies a misaligned view).  Not done: long rows split across warps (the
// longest C2 row, 1,347 entries, is 11 warp steps).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
constexpr int G = 32;                  // lanes per row
constexpr int ROWS_PER_BLOCK = THREADS / G;
#define FULL 0xffffffffu

enum { DT_F32 = 0, DT_F64 = 1 };

// 4 consecutive values from a 16-byte-aligned address: through the
// read-only path for x (load4), or marked evict-first for the matrix's
// streams (stream4), so that they do not push x out of L1
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void stream4(const float* p, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void stream4(const double* p, double* v) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// XV consecutive x values (one row's columns) as one vector load
template <int XV> __device__ __forceinline__ void loadx(const float* p, float* v);
template <> __device__ __forceinline__ void loadx<1>(const float* p, float* v) {
  v[0] = __ldg(p);
}
template <> __device__ __forceinline__ void loadx<2>(const float* p, float* v) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = a.x; v[1] = a.y;
}
template <> __device__ __forceinline__ void loadx<4>(const float* p, float* v) {
  load4(p, v);
}
template <int XV> __device__ __forceinline__ void loadx(const double* p, double* v);
template <> __device__ __forceinline__ void loadx<1>(const double* p, double* v) {
  v[0] = __ldg(p);
}
template <> __device__ __forceinline__ void loadx<2>(const double* p, double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = a.x; v[1] = a.y;
}
template <> __device__ __forceinline__ void loadx<4>(const double* p, double* v) {
  load4(p, v);
}

// acc[j] += v * x[c, c0 + j] for the chunk's mc columns (one scalar slot)
template <typename T, int MC, int XV>
__device__ __forceinline__ void slot_fma(T* acc, int mc, int c, T v,
                                         const T* __restrict__ x, int m,
                                         int c0) {
  T xv[MC];
  const T* xr = x + (size_t)c * m + c0;
#pragma unroll
  for (int j = 0; j < MC; j += XV)
    if (j < mc) loadx<XV>(xr + j, xv + j);
#pragma unroll
  for (int j = 0; j < MC; ++j)
    if (j < mc) acc[j] += v * xv[j];
}

template <typename T, int MC, int XV>
__global__ void __launch_bounds__(THREADS)
k_spmv(long long n_rows, int m, const long long* __restrict__ row_ptr,
       const int* __restrict__ row_nnz, const int* __restrict__ cols,
       const T* __restrict__ vals, const T* __restrict__ x,
       T* __restrict__ y) {
  constexpr int STEPS = MC <= 4 ? 2 : 1;      // 16-byte steps per iteration
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  const bool live = row < n_rows;      // a dead group still joins the shuffles
  const int c0 = blockIdx.y * MC;
  const int mc = m - c0 < MC ? m - c0 : MC;
  long long beg = 0, end = 0;
  if (live) {
    beg = row_ptr[row];
    end = beg + row_nnz[row];
  }
  T acc[MC];
#pragma unroll
  for (int j = 0; j < MC; ++j) acc[j] = T(0);

  // scalar head up to the first 4-slot boundary
  long long a = (beg + 3) & ~3LL;
  if (a > end) a = end;
  if (beg + lane < a) {
    const long long k = beg + lane;
    slot_fma<T, MC, XV>(acc, mc, __ldg(cols + k), __ldg(vals + k), x, m, c0);
  }
  // 16-byte body: lane owns quads lane, lane + G, ... of [a, end)
  const long long nq = (end - a) >> 2;
  const int4* cq = reinterpret_cast<const int4*>(cols + a);
  const T* vq = vals + a;
  for (long long q = lane; q < nq; q += G * STEPS) {
    int c[STEPS][4];
    T v[STEPS][4];
    T xv[STEPS][4][MC];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const long long qq = q + G * s;
      if (qq < nq) {
        const int4 ci = __ldcs(cq + qq);
        c[s][0] = ci.x; c[s][1] = ci.y; c[s][2] = ci.z; c[s][3] = ci.w;
        stream4(vq + 4 * qq, v[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      if (q + G * s < nq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* xr = x + (size_t)c[s][e] * m + c0;
#pragma unroll
          for (int j = 0; j < MC; j += XV)
            if (j < mc) loadx<XV>(xr + j, xv[s][e] + j);
        }
      }
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      if (q + G * s < nq) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < MC; ++j)
            if (j < mc) acc[j] += v[s][e] * xv[s][e][j];
      }
  }
  // scalar tail: the last (end - a) % 4 slots
  const long long t = a + 4 * nq + lane;
  if (t < end)
    slot_fma<T, MC, XV>(acc, mc, __ldg(cols + t), __ldg(vals + t), x, m, c0);

#pragma unroll
  for (int j = 0; j < MC; ++j) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(FULL, acc[j], off);
  }
  if (live && lane == 0) {
    T* yr = y + (size_t)row * m + c0;
#pragma unroll
    for (int j = 0; j < MC; ++j)
      if (j < mc) yr[j] = acc[j];
  }
}

template <typename T, int MC, int XV>
static void launch_one(dim3 grid, cudaStream_t st, long long n_rows, int m,
                       const long long* rp, const int* nnz, const int* c,
                       const void* vals, const void* x, void* y) {
  k_spmv<T, MC, XV><<<grid, THREADS, 0, st>>>(
      n_rows, m, rp, nnz, c, static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y));
}

template <typename T>
static cudaError_t launch(long long n_rows, int m, const long long* rp,
                          const int* nnz, const int* c, const void* vals,
                          const void* x, void* y, cudaStream_t st) {
  const int mc = m == 1 ? 1 : (m == 2 ? 2 : (m <= 4 ? 4 : 8));
  // x-row vector width: divides m and the chunk, so every gather is aligned
  const int xv = (m % 4 == 0 && mc >= 4) ? 4 : ((m % 2 == 0 && mc >= 2) ? 2 : 1);
  const long long bx = (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const long long by = (m + mc - 1) / mc;
  if (bx > 0x7fffffffLL || by > 65535) return cudaErrorInvalidValue;
  const dim3 g((unsigned)bx, (unsigned)by);
  switch (mc * 10 + xv) {
    case 11: launch_one<T, 1, 1>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
    case 21: launch_one<T, 2, 1>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
    case 22: launch_one<T, 2, 2>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
    case 41: launch_one<T, 4, 1>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
    case 42: launch_one<T, 4, 2>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
    case 44: launch_one<T, 4, 4>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
    case 81: launch_one<T, 8, 1>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
    case 82: launch_one<T, 8, 2>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
    default: launch_one<T, 8, 4>(g, st, n_rows, m, rp, nnz, c, vals, x, y); break;
  }
  return cudaGetLastError();
}

// No shared memory: all of the SM's L1 for the x gather.  Called once per
// device, with that device current, before the first launch there.
template <typename T>
static cudaError_t prefer_l1() {
  const void* k[] = {
      (const void*)k_spmv<T, 1, 1>, (const void*)k_spmv<T, 2, 1>,
      (const void*)k_spmv<T, 2, 2>, (const void*)k_spmv<T, 4, 1>,
      (const void*)k_spmv<T, 4, 2>, (const void*)k_spmv<T, 4, 4>,
      (const void*)k_spmv<T, 8, 1>, (const void*)k_spmv<T, 8, 2>,
      (const void*)k_spmv<T, 8, 4>};
  for (const void* f : k) {
    const cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxL1);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

extern "C" int sqmc_spmv_init() {
  const cudaError_t e = prefer_l1<float>();
  return (int)(e != cudaSuccess ? e : prefer_l1<double>());
}

// Plain C entry point (bound with ctypes).  row_ptr: [n_rows + 1] int64;
// row_nnz: [n_rows] int32, each at most row_ptr[i + 1] - row_ptr[i];
// cols: int32 slots, each in [0, n_x); vals: slots of dtype; x: [n_x, m];
// y: [n_rows, m], every entry written.  cols, vals and x 16-byte aligned.
extern "C" int sqmc_spmv(long long n_rows, int m, int dtype,
                         const void* row_ptr, const void* row_nnz,
                         const void* cols, const void* vals, const void* x,
                         void* y, void* stream) {
  if (n_rows <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(cols) | reinterpret_cast<uintptr_t>(vals) |
       reinterpret_cast<uintptr_t>(x)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const long long* rp = static_cast<const long long*>(row_ptr);
  const int* nnz = static_cast<const int*>(row_nnz);
  const int* c = static_cast<const int*>(cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return (int)launch<float>(n_rows, m, rp, nnz, c, vals, x, y, st);
  if (dtype == DT_F64) return (int)launch<double>(n_rows, m, rp, nnz, c, vals, x, y, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sqmc_spmv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
