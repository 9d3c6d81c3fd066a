// Heat-bath pair (and single) selection of the walk's spawn slots, for
// Hopper (sm_90a), in one launch.
//
// Replaces the selection rows of the JAX generation
// (sqmc_tpu/algo/walk.py:1539-1631): row cumsums built on
// sqmc_tpu/ops/prefix.py:53 `cumsum_rows`, a [*, K] x [K, K] triangular
// matmul on the TPU's MXU, then count-<=-target row compares and the
// realized cells `sel_cell` (:1524).  Per slot, over the parent's
// spin-orbitals a = 0 .. 2n-1 (up orbitals, then dn orbitals + n) with
// occupancy bit(a) in {0, 1} and R2 the [2n, 2n] heat-bath pair rowsums:
//
//   singles   rows_s[a] = running sum of bit(a) * u(a mod n)
//             utot = rows_s[2n-1];  o_s = draw(rows_s, u_pick * utot)
//             c_s = cell(rows_s, o_s)
//   doubles   mu[a] = sum over occupied q of R2[q, a]
//             rows_m[a] = running sum of bit(a) * mu[a];  m_tot = rows_m[2n-1]
//             o1 = draw(rows_m, u_pick * m_tot)
//             rows_1[a] = running sum of bit(a) * R2[o1, a];  s1q = rows_1[2n-1]
//             o2 = draw(rows_1, u_entry * s1q)
//             rows_2[a] = running sum of bit(a) * R2[o2, a];  s2q = rows_2[2n-1]
//             p_pair = (cell(rows_m, o1) cell(rows_1, o2) / max(s1q, TINY)
//                     + cell(rows_m, o2) cell(rows_2, o1) / max(s2q, TINY))
//                      / max(m_tot, TINY)
//
// with draw(rows, t) = min(#{a : rows[a] <= t}, 2n - 1), each target the
// float64 product rounded to float32, and cell(rows, i) = rows[i] -
// rows[i-1] (rows[0] at i = 0).  A draw and the cells that give its
// probability read the same stored running sums: that is the exact S/diff
// correction (the spawn weight divides by the probability the draw really
// used).  The summation order of the running sums is not torch.cumsum's,
// so only integer-valued inputs (every sum exact) give the plain version's
// bits; the products and the p_pair quotients are single IEEE roundings
// in the plain version's order (no contraction into FMAs).
//
// What bounds it: bytes.  Per slot the kernel reads the parent's det
// words (16 B at one word a spin) and two float64 uniforms (16 B) and
// writes two int64 and four float32 (32 B; singles add 16 B): at the walk's
// CAP = 262,144 slots 16.8 MB, 5.0 us at the H100's 3.35 TB/s.  Its float32
// work (~2e8 adds at HEG-14's 14 electrons and 2n = 38) is of the same
// order at the card's 67 TFLOP/s.  The rows the torch version wrote
// ([CAP, 2n] float32 each: bits, mu, four cumsums, the compare masks) never
// reach device memory.
//
// Design: a group of 8 lanes per slot, four slots per warp; a block's warps
// share R2 (and the singles weights) in shared memory when R2 fits there
// (2n up to ~220), else R2 is read through L1/L2.  Spin-orbitals go in
// chunks of 64, lane l of a group holding the 8 consecutive spin-orbitals
// 64c + 8l .. 64c + 8l + 7.  The running sums must be sequential sums --
// each the one before plus the next value -- and not a tree scan: an empty
// spin-orbital must repeat the sum before it exactly, or its cell is an ulp
// wide instead of 0, the draw lands there about once in 1e7 draws, and the
// spawn weight, divided by that cell, is ~1e7 times the normal one
// (population bursts and capacity overflows in the HEG-14 walk).  So a lane
// sums its 8 values in order and its base is the carry plus the lanes
// before it added in lane order (7 adds after 7 independent shuffles); the
// chunk's last sum carries into the next chunk.  mu at a lane's 8
// spin-orbitals is four 8-byte loads of the row R2[q] for each occupied q
// (the slot's occupied list, as row offsets q * 2n, from a scan of the
// lanes' bit counts).  The count of cells <= target is each lane's count
// summed over the group; the realized cells come from the slot's scratch
// copy of the same running sums.  All float32 on the CUDA cores: no tensor
// cores, no TF32.  Each output has one writer.
//
// Measured (chip_smoke.py phases 2d and 2c, H100): ~115 us of kernel time
// at the walk shape, 23x the bound (a warp per slot with two spin-orbitals
// a lane took 243 us), and ~163 us a generation inside the HEG-14 walk
// (bench_walk.py --profile).  A variant that read only the occupied
// entries of R2[q] in the mu loop (less shared-memory traffic) was 1-10%
// faster at these shapes and slower where R2 is read through L2, so
// shared-memory bandwidth is not what holds it back; which part of each
// slot's chain of dependent loads, shuffles and shared-memory round trips
// does is not measured yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;                  // warps per block
constexpr int G = 8;                          // lanes per slot
constexpr int V = 8;                          // spin-orbitals per lane
constexpr int CHUNK = G * V;                  // spin-orbitals per chunk
constexpr int SLOTS = 32 / G;                 // slots per warp
constexpr float TINY = 1e-30f;                // the walk's TINY in float32

struct Args {
  const unsigned long long* up;               // [cap, n_words] det words
  const unsigned long long* dn;
  const float* r2;                            // [n2, n2]
  const double* u_rowsum;                     // [norb], nullptr: no singles
  const double* u_pick;                       // [cap] o1 / o_s stream
  const double* u_entry;                      // [cap] o2 stream
  long long* o1;
  long long* o2;
  long long* o_s;
  float* m_tot;
  float* s1q;
  float* s2q;
  float* p_pair;
  float* utot;
  float* c_s;
  long long cap;
  int n_words, norb, n2;
};

// a slot's scratch in shared memory: two rows of running sums, the
// occupied list and one occupancy byte per lane and chunk
__host__ __device__ inline int slot_bytes(int n2) {
  const int nch = (n2 + CHUNK - 1) / CHUNK;
  return 3 * n2 * 4 + ((nch * G + 7) / 8) * 8;
}

__device__ __forceinline__ float2 ld2(const float* p, bool shared) {
  return shared ? *reinterpret_cast<const float2*>(p)
                : __ldg(reinterpret_cast<const float2*>(p));
}

// occupancy of spin-orbital s (up orbitals first, then dn + norb)
__device__ __forceinline__ unsigned bit_of(const unsigned long long* up,
                                           const unsigned long long* dn,
                                           int s, int norb) {
  const int i = s < norb ? s : s - norb;
  return (unsigned)((__ldg((s < norb ? up : dn) + (i >> 6)) >> (i & 63)) & 1ull);
}

__device__ __forceinline__ float target(double u, float total) {
  return __double2float_rn(__dmul_rn(u, (double)total));
}

__device__ __forceinline__ float at_least_tiny(float x) {
  return x < TINY ? TINY : x;               // NaN stays NaN, as clamp(min=)
}

// Running sums rows[a] of bit(a) * x(a) over a = 0 .. n2-1, written to
// the slot's rows; masks[c * G + gl] holds the lane's occupancy bits of
// chunk c; x(a, xv) fills xv[0 .. V-1] with x at a .. a + V - 1 (pairs past
// n2 are not read).  Each lane sums its V values in order (pre), and its
// base is the chunk's carry plus the lanes before it, added in lane order,
// so every sum is the last one plus the next value: an empty spin-orbital
// repeats the sum before it exactly and the sums never decrease.  Returns
// rows[n2-1].
template <typename X>
__device__ float running_sums(const unsigned char* masks, X x, float* rows,
                              int n2, int gl) {
  __syncwarp();                             // earlier reads of rows are done
  float carry = 0.f;
  for (int c0 = 0, c = 0; c0 < n2; c0 += CHUNK, ++c) {
    const int a = c0 + V * gl;
    float pre[V];
    float s = 0.f;
    if (a < n2) {
      const unsigned m = masks[c * G + gl];
      float xv[V];
      x(a, xv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s = __fadd_rn(s, __fmul_rn((float)((m >> i) & 1u), xv[i]));
        pre[i] = s;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) pre[i] = 0.f;
    }
    float base = carry;
#pragma unroll
    for (int l = 0; l < G - 1; ++l) {
      const float nb = __fadd_rn(base, __shfl_sync(FULL, s, l, G));
      if (gl > l) base = nb;
    }
#pragma unroll
    for (int i = 0; i < V; i += 2)
      if (a + i < n2)
        *reinterpret_cast<float2*>(rows + a + i) =
            make_float2(__fadd_rn(base, pre[i]), __fadd_rn(base, pre[i + 1]));
    carry = __shfl_sync(FULL, __fadd_rn(base, s), G - 1, G);
  }
  __syncwarp();
  return carry;
}

// min(#{a : rows[a] <= t}, n2 - 1) over the slot's rows
__device__ int draw(const float* rows, float t, int n2, int gl) {
  int count = 0;
  for (int c0 = 0; c0 < n2; c0 += CHUNK) {
    const int a = c0 + V * gl;
#pragma unroll
    for (int i = 0; i < V; i += 2)
      if (a + i < n2) {
        const float2 r = *reinterpret_cast<const float2*>(rows + a + i);
        count += (r.x <= t) + (r.y <= t);
      }
  }
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1)
    count += __shfl_xor_sync(FULL, count, d, G);
  return min(count, n2 - 1);
}

__device__ __forceinline__ float cell(const float* rows, int i) {
  return i > 0 ? __fsub_rn(rows[i], rows[i - 1]) : rows[i];
}

template <bool SMEM_R2>
__global__ void __launch_bounds__(MAX_WARPS * 32) k_hb_select(Args p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n2 = p.n2, norb = p.norb, W = p.n_words;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / G, gl = lane % G;
  const int wpb = blockDim.x >> 5;
  const bool singles = p.u_rowsum != nullptr;

  // block preamble: R2 and the singles weights u(a mod n) in float32
  float* r2s = sm;
  float* u2 = sm + (SMEM_R2 ? n2 * n2 : 0);
  if (SMEM_R2) {
    const float4* src = reinterpret_cast<const float4*>(p.r2);
    for (int i = threadIdx.x; i < n2 * n2 / 4; i += blockDim.x)
      smem4[i] = __ldg(src + i);
  }
  for (int a = threadIdx.x; a < n2; a += blockDim.x)
    u2[a] = singles ? __double2float_rn(p.u_rowsum[a < norb ? a : a - norb])
                    : 0.f;
  __syncthreads();
  const float* R = SMEM_R2 ? r2s : p.r2;

  // this group's slot scratch
  char* scratch = reinterpret_cast<char*>(u2 + n2)
                  + (size_t)(warp * SLOTS + g) * slot_bytes(n2);
  float* rows_m = reinterpret_cast<float*>(scratch);
  float* rows = rows_m + n2;
  int* occ = reinterpret_cast<int*>(rows + n2);
  unsigned char* masks = reinterpret_cast<unsigned char*>(occ + n2);

  const long long stride = (long long)gridDim.x * wpb * SLOTS;
  for (long long base = ((long long)blockIdx.x * wpb + warp) * SLOTS;
       base < p.cap; base += stride) {
    const long long slot = base + g;
    const bool live = slot < p.cap;
    const long long rs = live ? slot : p.cap - 1;     // read in bounds
    const unsigned long long* up = p.up + rs * W;
    const unsigned long long* dn = p.dn + rs * W;
    const double u_pick = p.u_pick[rs];
    const double u_entry = p.u_entry[rs];
    __syncwarp();                           // the last slot's reads are done

    // occupancy bytes and the ascending occupied list
    int ne = 0;
    for (int c0 = 0, c = 0; c0 < n2; c0 += CHUNK, ++c) {
      const int a = c0 + V * gl;
      unsigned m = 0;
      if (a < n2) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (a + i < n2) m |= bit_of(up, dn, a + i, norb) << i;
        masks[c * G + gl] = (unsigned char)m;
      }
      const int cnt = __popc(m);
      int inc = cnt;
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int t = __shfl_up_sync(FULL, inc, d, G);
        if (gl >= d) inc += t;
      }
      int k = ne + inc - cnt;
      for (unsigned r = m; r; r &= r - 1)
        occ[k++] = (a + __ffs(r) - 1) * n2;
      ne += __shfl_sync(FULL, inc, G - 1, G);
    }
    __syncwarp();

    int o_s = 0;
    float utot = 0.f, c_s = 0.f;
    if (singles) {
      utot = running_sums(masks, [&](int a, float* xv) {
#pragma unroll
        for (int i = 0; i < V; i += 2)
          if (a + i < n2) {
            const float2 r = *reinterpret_cast<const float2*>(u2 + a + i);
            xv[i] = r.x;
            xv[i + 1] = r.y;
          } else {
            xv[i] = xv[i + 1] = 0.f;
          }
      }, rows, n2, gl);
      o_s = draw(rows, target(u_pick, utot), n2, gl);
      c_s = cell(rows, o_s);
    }

    const float m_tot = running_sums(masks, [&](int a, float* xv) {
#pragma unroll
      for (int i = 0; i < V; ++i) xv[i] = 0.f;
      for (int j = 0; j < ne; ++j) {
        const float* row = R + occ[j] + a;
#pragma unroll
        for (int i = 0; i < V; i += 2)
          if (a + i < n2) {
            const float2 r = ld2(row + i, SMEM_R2);
            xv[i] = __fadd_rn(xv[i], r.x);
            xv[i + 1] = __fadd_rn(xv[i + 1], r.y);
          }
      }
    }, rows_m, n2, gl);
    const int o1 = draw(rows_m, target(u_pick, m_tot), n2, gl);

    const float* r_o1 = R + (size_t)o1 * n2;
    auto gather = [&](const float* row) {
      return [=](int a, float* xv) {
#pragma unroll
        for (int i = 0; i < V; i += 2)
          if (a + i < n2) {
            const float2 r = ld2(row + a + i, SMEM_R2);
            xv[i] = r.x;
            xv[i + 1] = r.y;
          } else {
            xv[i] = xv[i + 1] = 0.f;
          }
      };
    };
    const float s1q = running_sums(masks, gather(r_o1), rows, n2, gl);
    const int o2 = draw(rows, target(u_entry, s1q), n2, gl);
    const float c12 = cell(rows, o2);

    const float s2q = running_sums(masks, gather(R + (size_t)o2 * n2), rows,
                                   n2, gl);
    const float c21 = cell(rows, o1);

    if (live && gl == 0) {
      const float q1 = __fdiv_rn(__fmul_rn(cell(rows_m, o1), c12),
                                 at_least_tiny(s1q));
      const float q2 = __fdiv_rn(__fmul_rn(cell(rows_m, o2), c21),
                                 at_least_tiny(s2q));
      p.o1[slot] = o1;
      p.o2[slot] = o2;
      p.m_tot[slot] = m_tot;
      p.s1q[slot] = s1q;
      p.s2q[slot] = s2q;
      p.p_pair[slot] = __fdiv_rn(__fadd_rn(q1, q2), at_least_tiny(m_tot));
      if (singles) {
        p.o_s[slot] = o_s;
        p.utot[slot] = utot;
        p.c_s[slot] = c_s;
      }
    }
  }
}

int opt_in_bytes(int dev) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

}  // namespace

// Lets both kernels use all the shared memory a block may opt into.  Called
// once per device, with that device current.
extern "C" int sqmc_hb_select_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int bytes = opt_in_bytes(dev);
  e = cudaFuncSetAttribute(k_hb_select<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      k_hb_select<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// up, dn: [cap, n_words] int64 det words; r2: [2 norb, 2 norb] float32,
// 16-byte aligned; u_rowsum: [norb] float64 or null (no singles: o_s, utot
// and c_s are not written); u_pick, u_entry: [cap] float64; o1, o2, o_s:
// [cap] int64; m_tot, s1q, s2q, p_pair, utot, c_s: [cap] float32.
extern "C" int sqmc_hb_select(long long cap, int n_words, int norb,
                              const void* up, const void* dn, const void* r2,
                              const void* u_rowsum, const void* u_pick,
                              const void* u_entry, void* o1, void* o2,
                              void* o_s, void* m_tot, void* s1q, void* s2q,
                              void* p_pair, void* utot, void* c_s,
                              void* stream) {
  if (cap <= 0 || norb <= 0 || n_words * 64 < norb)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(r2) & 15)
    return (int)cudaErrorMisalignedAddress;
  Args a;
  a.up = static_cast<const unsigned long long*>(up);
  a.dn = static_cast<const unsigned long long*>(dn);
  a.r2 = static_cast<const float*>(r2);
  a.u_rowsum = static_cast<const double*>(u_rowsum);
  a.u_pick = static_cast<const double*>(u_pick);
  a.u_entry = static_cast<const double*>(u_entry);
  a.o1 = static_cast<long long*>(o1);
  a.o2 = static_cast<long long*>(o2);
  a.o_s = static_cast<long long*>(o_s);
  a.m_tot = static_cast<float*>(m_tot);
  a.s1q = static_cast<float*>(s1q);
  a.s2q = static_cast<float*>(s2q);
  a.p_pair = static_cast<float*>(p_pair);
  a.utot = static_cast<float*>(utot);
  a.c_s = static_cast<float*>(c_s);
  a.cap = cap;
  a.n_words = n_words;
  a.norb = norb;
  a.n2 = 2 * norb;

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long optin = opt_in_bytes(dev);
  const long long n2 = a.n2;
  const long long warp_bytes = (long long)SLOTS * slot_bytes(a.n2);
  const long long r2_bytes = n2 * n2 * 4;
  const bool smem_r2 = r2_bytes + n2 * 4 + MAX_WARPS * warp_bytes <= optin;
  int wpb = MAX_WARPS;
  long long bytes = 0;
  for (;;) {
    bytes = (smem_r2 ? r2_bytes : 0) + n2 * 4 + wpb * warp_bytes;
    if (bytes <= optin || wpb == 1) break;
    wpb /= 2;
  }
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  const void* kfn = smem_r2 ? (const void*)k_hb_select<true>
                            : (const void*)k_hb_select<false>;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kfn, wpb * 32,
                                                    (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  // one wave of resident blocks; each warp takes every (grid x wpb)-th
  // group of SLOTS slots
  const long long per_block = (long long)wpb * SLOTS;
  const long long want = (cap + per_block - 1) / per_block;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem_r2)
    k_hb_select<true><<<blocks, wpb * 32, (size_t)bytes, st>>>(a);
  else
    k_hb_select<false><<<blocks, wpb * 32, (size_t)bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* sqmc_hb_select_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
