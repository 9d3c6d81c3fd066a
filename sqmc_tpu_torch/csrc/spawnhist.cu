// The walk's log2-binned histogram of |spawn weight|, for Hopper (sm_90a).
//
// Replaces the one-hot sum of sqmc_tpu/algo/walk.py:2633-2644 (ref:
// gen_hist / add_to_hist, more_tools.f90:5449): a [CAP, 40] one-hot
// reduced over the slots, the TPU's way around a scatter.  The port first
// ran it as a scatter-add into 41 int64 bins; every slot that was not
// drawn or was rejected went to the one discard bin, and atomics to one
// address run one after another in L2 (3.6 ms a generation at 5,242,880
// slots, 94% of them discarded).  This kernel gives the same counts:
//     bin(w) = clamp(floor(log2(max(|w|, TINY))) + 20, 0, 39)
// in the weight's own type (log2f / floorf for float, log2 / floor for
// double: the functions torch's CUDA ops call, without fast math, so
// one ulp below a power of two gives the bin a rounded log2 gives, not
// the exponent's), counted where ok and |w| > 0 (NaN fails the test);
// other slots count nowhere (the discard bin is not an output).
//
// What bounds it: bytes.  Each slot's weight and flag are read once (5 B
// a slot in float, 9 in double) and 40 int64 counts written: at
// heg54.walk's CAP (5,242,880 slots, float) 26.2 MB, 7.8 us at the H100's
// 3.35 TB/s; at c2.walk-pop2e6's (2,621,440) 13.1 MB, 3.9 us.
//
// Design: a grid-stride stream over vectors of 4 slots (one 16-byte load
// of float weights or two of double, one 4-byte load of the flags), two
// vectors in flight a thread, two blocks of 512 threads an SM.  Each
// thread counts in its own column of a [40][512] uint32 array in shared
// memory (thread t's bin b at b * 512 + t: consecutive threads hit
// consecutive banks, and no count is shared, so no atomics and no
// conflicts).  The block then sums each bin over its 512 columns (one
// warp a bin, 16 loads a lane and a warp reduction) and adds each nonzero
// total to the global int64 bin with one atomic: at most 40 atomics a
// block, a few thousand a call on 264 blocks.  The slots past the last
// whole vector are counted by block 0.  Counts are integers, so the
// output equals the plain version's whatever the order of the adds.  The
// wrapper (ops/spawnhist.py) allocates and zeroes the output; the kernel
// does not sync and allocates nothing, so it runs inside the captured
// generation.
//
// Measured (chip_smoke.py phase 2f, NVIDIA H100 80GB HBM3, 700.00 W;
// device us a call in a CUDA graph): 13.8 us at heg54.walk's CAP (share
// 0.57 of the bound), 11.7 us at pop2e6's (0.34: ~2.5 vectors a thread,
// so the block's zeroing and sums weigh); the torch chain it replaced
// took 3,798 and 1,466 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int BINS = 40;                      // N_HIST_BINS, ops/spawnhist.py
constexpr int VEC = 4;                        // slots a vector
constexpr int UNROLL = 2;                     // vectors in flight a thread
constexpr int SMEM = BINS * THREADS * 4;      // 81,920 B: a column a thread
constexpr int MIN_BLOCKS = 2;                 // blocks an SM

__device__ __forceinline__ float log2_of(float x) { return log2f(x); }
__device__ __forceinline__ double log2_of(double x) { return log2(x); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }

// The bin of weight w, or -1 for a slot that counts nowhere.  TINY is the
// double 1e-30 rounded to WT, as torch's clamp rounds its scalar.
template <typename WT>
__device__ __forceinline__ int bin_of(WT w) {
  const WT a = w < WT(0) ? -w : w;
  if (!(a > WT(0))) return -1;
  const WT tiny = static_cast<WT>(1e-30);
  WT f = floor_of(log2_of(a > tiny ? a : tiny)) + WT(20);
  f = f < WT(0) ? WT(0) : f;
  f = f > WT(BINS - 1) ? WT(BINS - 1) : f;
  return static_cast<int>(f);
}

__device__ __forceinline__ void load_vec(const float* __restrict__ wt,
                                         long long v, float (&w)[VEC]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(wt) + v);
  w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
}

__device__ __forceinline__ void load_vec(const double* __restrict__ wt,
                                         long long v, double (&w)[VEC]) {
  const double2* p = reinterpret_cast<const double2*>(wt) + 2 * v;
  const double2 x = __ldg(p), y = __ldg(p + 1);
  w[0] = x.x; w[1] = x.y; w[2] = y.x; w[3] = y.y;
}

template <typename WT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
k_spawn_hist(const WT* __restrict__ wt, const uint8_t* __restrict__ ok,
             long long n, unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned cnt[];           // [BINS][THREADS]
  const int t = threadIdx.x;
  unsigned* mine = cnt + t;
#pragma unroll
  for (int b = 0; b < BINS; ++b) mine[b * THREADS] = 0;

  const long long nv = n / VEC;
  const long long stride = (long long)gridDim.x * THREADS;
  const uint32_t* okv = reinterpret_cast<const uint32_t*>(ok);
  for (long long v = (long long)blockIdx.x * THREADS + t; v < nv;
       v += UNROLL * stride) {
    WT w[UNROLL][VEC];
    uint32_t f[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long vu = v + u * stride;
      f[u] = 0;
      if (vu < nv) {
        f[u] = __ldg(okv + vu);
        load_vec(wt, vu, w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if ((f[u] >> (8 * k)) & 0xffu) {
          const int b = bin_of(w[u][k]);
          if (b >= 0) mine[b * THREADS] += 1;
        }
      }
    }
  }
  if (blockIdx.x == 0 && t < n - nv * VEC) {  // the last n % 4 slots
    const long long s = nv * VEC + t;
    if (ok[s]) {
      const int b = bin_of(wt[s]);
      if (b >= 0) mine[b * THREADS] += 1;
    }
  }
  __syncthreads();

  const int warp = t / 32, lane = t % 32;
  for (int b = warp; b < BINS; b += THREADS / 32) {
    unsigned s = 0;
#pragma unroll
    for (int k = lane; k < THREADS; k += 32) s += cnt[b * THREADS + k];
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0 && s != 0) atomicAdd(hist + b, (unsigned long long)s);
  }
}

constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES];                       // SMs of each device
int g_per_sm[MAX_DEVICES][2];                 // resident blocks, f32 / f64

long long grid_of(long long n, int dev, int f64) {
  const long long nv = n / VEC;
  const long long want = (nv + THREADS - 1) / THREADS;
  const long long most = (long long)g_sms[dev] * g_per_sm[dev][f64];
  const long long blocks = want < most ? want : most;
  return blocks > 0 ? blocks : 1;
}

int current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  if (*dev < 0 || *dev >= MAX_DEVICES || g_sms[*dev] == 0)
    return (int)cudaErrorInitializationError;     // init not run here
  return 0;
}

}  // namespace

// Launch attributes on the current device (the 81,920 B of dynamic shared
// memory) and its SM count and resident blocks, kept for the grid.
extern "C" int sqmc_spawn_hist_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  e = cudaFuncSetAttribute(k_spawn_hist<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(k_spawn_hist<double>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &g_per_sm[dev][0], k_spawn_hist<float>, THREADS, SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &g_per_sm[dev][1], k_spawn_hist<double>, THREADS, SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// The launch for n slots: out[0] blocks, out[1] threads a block, out[2]
// dynamic shared bytes a block, out[3] resident blocks per SM, out[4]
// slots a thread takes from each vector load.
extern "C" int sqmc_spawn_hist_shape(long long n, int f64, long long* out) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const int err = current_device(&dev);
  if (err != 0) return err;
  out[0] = grid_of(n, dev, f64 != 0);
  out[1] = THREADS;
  out[2] = SMEM;
  out[3] = g_per_sm[dev][f64 != 0];
  out[4] = VEC;
  return 0;
}

// wt: [n] float (f64 = 0) or double (f64 = 1), 16-byte aligned; ok: [n]
// bytes (torch.bool), 4-byte aligned; hist: [40] int64, zeroed by the
// caller, to which the counts are added.
extern "C" int sqmc_spawn_hist(long long n, int f64, const void* wt,
                               const void* ok, void* hist, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const int err = current_device(&dev);
  if (err != 0) return err;
  const unsigned blocks = (unsigned)grid_of(n, dev, f64 != 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* h = static_cast<unsigned long long*>(hist);
  auto* f = static_cast<const uint8_t*>(ok);
  if (f64)
    k_spawn_hist<double><<<blocks, THREADS, SMEM, s>>>(
        static_cast<const double*>(wt), f, n, h);
  else
    k_spawn_hist<float><<<blocks, THREADS, SMEM, s>>>(
        static_cast<const float*>(wt), f, n, h);
  return (int)cudaGetLastError();
}

extern "C" const char* sqmc_spawn_hist_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
