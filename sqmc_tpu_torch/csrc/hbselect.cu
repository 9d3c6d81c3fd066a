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
// probability read the same running sums: that is the exact S/diff
// correction (the spawn weight divides by the probability the draw really
// used).  The products and the p_pair quotients are single IEEE roundings
// in the plain version's order (no contraction into FMAs).
//
// The association: every running sum is the sum before it plus the next
// occupied spin-orbital's value, in float32, in ascending spin-orbital
// order -- np.cumsum(bit * x, dtype=float32), which is sequential -- and
// mu[a] is a sequential float32 sum over the occupied q in ascending
// order.  An empty spin-orbital adds 0 * x = +0 for the finite x >= 0
// that R2 and the singles weights hold, so leaving it out gives the same
// bits, and the sums are flat across it by construction: its cell is
// exactly 0 and no draw lands there.  (A tree scan does not repeat the sum
// across an empty spin-orbital; an ulp-wide cell there is drawn about once
// in 1e7 draws with a spawn weight ~1e7 times the normal one.)  Integer
// inputs make every sum exact, so they give the plain version's bits.
//
// What bounds it: bytes.  Per slot the kernel reads the parent's det
// words (16 B at one word a spin) and two float64 uniforms (16 B) and
// writes two int64 and four float32 (32 B; singles add 16 B): at the walk's
// CAP = 262,144 slots 16.8 MB, 5.0 us at the H100's 3.35 TB/s.  Its float32
// work at HEG-14's 14 electrons (2n = 38) is ne^2 = 196 adds for mu and
// ~6 ne for the sums a slot, ~7e7 in all: 1.1 us at the card's 67 TFLOP/s.
//
// Design: one thread per slot, no shared-memory scratch, no warp
// collectives.  The first version gave a slot 8 lanes and kept its rows
// in shared memory: each slot ran a chain of 2n single-bit loads, a
// shuffle scan for its occupied list, four passes of __syncwarp, shuffles
// and scratch stores over all 2n spin-orbitals and three draws that read
// the scratch again (115 us, 23x the bound; latency, not shared-memory
// bandwidth, held it).  Here a thread reads its det's words once, as
// 64-bit loads, and walks the occupied spin-orbitals with __ffsll and
// w &= w - 1, so every loop runs ne times, the same ne for every live slot
// of a warp.  mu is needed only at the ne occupied a (bit(a) mu[a] is 0
// elsewhere): ne^2 reads of R2, which a block keeps in shared memory with
// an odd row stride (2n + 1) when it fits (2n up to ~240), else reads
// through L1/L2.  Sums are not stored: a total is one pass over the ne
// values, a draw repeats the same adds in the same order (the same bits)
// and stops at the first sum above the target, its cell (prev + v) - prev
// from those sums.  At one word a spin and up to 16 electrons (every walk
// the package runs), the occupied list and mu at its entries stay in
// registers (the loops unroll over 16; 64 registers a thread, four blocks
// an SM), so mu is summed once, one occupied R2 row at a time into the
// accumulators.  A det with every spin-orbital occupied -- the walk's
// empty-slot sentinel (all bits set), which fills every slot past the
// spawn total, ~30% of them at HEG-14 -- takes mu from R2's column sums,
// which each block adds once in the same order.  Any other det (more than
// 16 electrons or more than one word a spin) recomputes mu in each pass
// that needs it, ne^2 reads a pass: several times slower than the
// register path, and slower than the first version's kernel (PERF.md).
// All float32 on the CUDA cores: no tensor cores, no TF32.  Each output
// has one writer.  The grid is one wave of resident blocks, each looping
// over slots.
//
// Measured (chip_smoke.py phase 2d, bench_walk.py, NVIDIA H100 80GB HBM3,
// 700 W): 33 us at the walk shape, 26 us at 2n = 52 with singles, against
// 115 and 129 us for the 8-lane kernel; ~39 us a generation inside the
// HEG-14 walk, against 163.  Still 6-7x the bytes bound: the limit is
// instruction issue and shared-memory reads of R2 at one slot a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;                  // slots (threads) a block
constexpr int MINBLOCKS = 4;                  // resident blocks ptxas plans for
constexpr int REG_NE = 16;                    // electrons the register path takes
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
  int st;                                     // R2's row stride as read
};

// A slot's det: NW > 0 holds up to NW words a spin in registers (words
// past n_words are 0); NW = 0 takes any n_words and reads them again
// through L1 at each pass.  Bits at or past norb are masked off.
template <int NW>
struct Det {
  static constexpr int K = NW > 0 ? 2 * NW : 1;
  unsigned long long w[K];
  const unsigned long long* up;
  const unsigned long long* dn;
  int nw, norb;

  __device__ __forceinline__ unsigned long long mask(unsigned long long x,
                                                     int i) const {
    const int left = norb - 64 * i;           // orbitals in word i
    return left >= 64 ? x : left <= 0 ? 0ull : x & ((1ull << left) - 1ull);
  }
  __device__ __forceinline__ Det(const unsigned long long* up_,
                                 const unsigned long long* dn_, int W,
                                 int norb_)
      : up(up_), dn(dn_), nw(W), norb(norb_) {
    if (NW > 0) {
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        w[i] = i < W ? mask(__ldg(up + i), i) : 0ull;
        w[NW + i] = i < W ? mask(__ldg(dn + i), i) : 0ull;
      }
    }
  }
  __device__ __forceinline__ int words() const {
    return NW > 0 ? 2 * NW : 2 * nw;
  }
  __device__ __forceinline__ unsigned long long word(int k) const {
    if (NW > 0) return w[k];
    return k < nw ? mask(__ldg(up + k), k) : mask(__ldg(dn + k - nw), k - nw);
  }
  // the spin-orbital of bit 0 of word k
  __device__ __forceinline__ int base(int k) const {
    const int v = NW > 0 ? NW : nw;
    return k < v ? 64 * k : norb + 64 * (k - v);
  }
};

// The occupied spin-orbitals in ascending order, walked over the det's
// words: calls f(a, k) for the k-th one, a its spin-orbital, until f
// returns true.
template <int NW>
struct BitSeq {
  const Det<NW>& d;
  template <typename F>
  __device__ __forceinline__ void operator()(F f) const {
    int k = 0;
#pragma unroll
    for (int i = 0; i < d.words(); ++i) {
      unsigned long long m = d.word(i);
      const int base = d.base(i);
      while (m) {
        const int a = base + __ffsll((long long)m) - 1;
        m &= m - 1ull;
        if (f(a, k++)) return;
      }
    }
  }
};

// The same walk over an occupied list held in registers (ne <= N): the
// loop unrolls, so k is a constant in each copy of f.
template <int N>
struct RegSeq {
  const int (&occ)[N];
  int ne;
  template <typename F>
  __device__ __forceinline__ void operator()(F f) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= ne) return;
      if (f(occ[k], k)) return;
    }
  }
};

// Every spin-orbital a = k = 0 .. n2-1 in order.
struct AllSeq {
  int n2;
  template <typename F>
  __device__ __forceinline__ void operator()(F f) const {
    for (int a = 0; a < n2; ++a)
      if (f(a, a)) return;
  }
};

// rows[2n-1]: the values v(a, k) of the occupied a added in order
template <typename Seq, typename V>
__device__ __forceinline__ float total(const Seq& seq, V v) {
  float s = 0.f;
  seq([&](int a, int k) {
    s = __fadd_rn(s, v(a, k));
    return false;
  });
  return s;
}

// cell(rows, i) from the same adds: rows[i] - rows[i-1], rows[0] at i = 0;
// an empty i repeats the sum before it, rows[i] = rows[i-1]
template <typename Seq, typename V>
__device__ __forceinline__ float cell_at(const Seq& seq, V v, int i) {
  float s = 0.f, c = 0.f;
  bool hit = false;
  seq([&](int a, int k) {
    if (a > i) return true;
    const float nx = __fadd_rn(s, v(a, k));
    if (a == i) {
      c = i > 0 ? __fsub_rn(nx, s) : nx;
      hit = true;
      return true;
    }
    s = nx;
    return false;
  });
  return hit ? c : (i > 0 ? __fsub_rn(s, s) : s);
}

// the total and, in the same pass, cell(rows, i)
template <typename Seq, typename V>
__device__ __forceinline__ float total_and_cell(const Seq& seq, V v, int i,
                                                float* cell) {
  float s = 0.f, c = 0.f;
  bool hit = false;
  seq([&](int a, int k) {
    const float nx = __fadd_rn(s, v(a, k));
    if (!hit && a >= i) {
      c = a == i ? (i > 0 ? __fsub_rn(nx, s) : nx)
                 : (i > 0 ? __fsub_rn(s, s) : s);
      hit = true;
    }
    s = nx;
    return false;
  });
  *cell = hit ? c : (i > 0 ? __fsub_rn(s, s) : s);
  return s;
}

// draw(rows, t) = min(#{a : rows[a] <= t}, n2 - 1) and cell(rows, draw).
// The rows are +0 before the first occupied spin-orbital and never fall,
// so for t >= 0 the count is the first occupied a whose sum is not <= t.
template <typename Seq, typename V>
__device__ __forceinline__ int draw(const Seq& seq, V v, float t, int n2,
                                    float* cell) {
  if (!(0.f <= t)) {                          // NaN: no row is <= t
    *cell = cell_at(seq, v, 0);
    return 0;
  }
  float s = 0.f, prev = 0.f, c = 0.f;
  int idx = -1, last = -1;
  seq([&](int a, int k) {
    const float nx = __fadd_rn(s, v(a, k));
    if (!(nx <= t)) {
      idx = a;
      c = __fsub_rn(nx, s);
      return true;
    }
    prev = s;
    s = nx;
    last = a;
    return false;
  });
  if (idx < 0) {                              // every row <= t
    idx = n2 - 1;
    c = last == n2 - 1 ? __fsub_rn(s, prev) : __fsub_rn(s, s);
  }
  *cell = c;
  return idx;
}

__device__ __forceinline__ float target(double u, float total) {
  return __double2float_rn(__dmul_rn(u, (double)total));
}

__device__ __forceinline__ float at_least_tiny(float x) {
  return x < TINY ? TINY : x;               // NaN stays NaN, as clamp(min=)
}

struct Sel {
  int o1, o2, o_s;
  float m_tot, s1q, s2q, p_pair, utot, c_s;
};

// The selection of one slot over `seq`, with mu(a, k) the mu row's value
// at the k-th occupied spin-orbital a and rd(i) the i-th float of R2 as
// stored (row stride st).
template <typename Seq, typename Mu, typename Rd>
__device__ __forceinline__ Sel select_slot(const Seq& seq, Mu mu, Rd rd,
                                           int st, const float* u2, int n2,
                                           bool singles, double u_pick,
                                           double u_entry) {
  Sel r;
  r.o_s = 0;
  r.utot = r.c_s = 0.f;
  if (singles) {
    auto vs = [&](int a, int) { return u2[a]; };
    r.utot = total(seq, vs);
    r.o_s = draw(seq, vs, target(u_pick, r.utot), n2, &r.c_s);
  }
  float cm1, c12, c21;
  r.m_tot = total(seq, mu);
  r.o1 = draw(seq, mu, target(u_pick, r.m_tot), n2, &cm1);
  const int b1 = r.o1 * st;
  auto v1 = [&](int a, int) { return rd(b1 + a); };
  r.s1q = total(seq, v1);
  r.o2 = draw(seq, v1, target(u_entry, r.s1q), n2, &c12);
  const int b2 = r.o2 * st;
  auto v2 = [&](int a, int) { return rd(b2 + a); };
  r.s2q = total_and_cell(seq, v2, r.o1, &c21);
  const float cm2 = cell_at(seq, mu, r.o2);
  const float q1 = __fdiv_rn(__fmul_rn(cm1, c12), at_least_tiny(r.s1q));
  const float q2 = __fdiv_rn(__fmul_rn(cm2, c21), at_least_tiny(r.s2q));
  r.p_pair = __fdiv_rn(__fadd_rn(q1, q2), at_least_tiny(r.m_tot));
  return r;
}

// The selection with the det's first N occupied spin-orbitals (ne <= N)
// and mu at them held in registers: every loop unrolls over N, so each
// index into occ and mu is a constant.  mu[k] gathers R2[q, occ[k]] one
// occupied row q at a time, in ascending q (the sequential order), over
// all N entries (entries past ne read row q's column 0 and are not used).
template <int N, int NW, typename Rd>
__device__ __forceinline__ Sel select_regs(const Det<NW>& det, int ne, Rd rd,
                                           int st, const float* u2, int n2,
                                           bool singles, double u_pick,
                                           double u_entry) {
  int occ[N];
  unsigned long long m[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) m[i] = det.w[i];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int a = 0;
    bool got = false;
#pragma unroll
    for (int i = 0; i < 2 * NW; ++i)
      if (!got && m[i] != 0ull) {
        a = det.base(i) + __ffsll((long long)m[i]) - 1;
        m[i] &= m[i] - 1ull;
        got = true;
      }
    occ[k] = a;
  }
  float mu[N];
#pragma unroll
  for (int k = 0; k < N; ++k) mu[k] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j >= ne) break;
    const int row = occ[j] * st;
#pragma unroll
    for (int k = 0; k < N; ++k) mu[k] = __fadd_rn(mu[k], rd(row + occ[k]));
  }
  const RegSeq<N> seq{occ, ne};
  return select_slot(seq, [&](int, int k) { return mu[k]; }, rd, st, u2, n2,
                     singles, u_pick, u_entry);
}

// NW = 1: one word a spin, dets of up to REG_NE electrons on the register
// path; NW = 0: any det, mu recomputed in each pass.
template <int NW, bool SMEM_R2>
__global__ void __launch_bounds__(THREADS, MINBLOCKS) k_hb_select(Args p) {
  extern __shared__ float sm[];
  const int n2 = p.n2, norb = p.norb, st = p.st;
  const bool singles = p.u_rowsum != nullptr;

  // block preamble: R2 at row stride st, the singles weights u(a mod n)
  // in float32 and R2's column sums (mu of a det with every spin-orbital
  // occupied)
  float* u2 = sm + (SMEM_R2 ? n2 * st : 0);
  float* colsum = u2 + n2;
  if (SMEM_R2)
    for (int i = threadIdx.x; i < n2 * n2; i += blockDim.x) {
      const int row = i / n2;
      sm[row * st + i - row * n2] = __ldg(p.r2 + i);
    }
  if (singles)
    for (int a = threadIdx.x; a < n2; a += blockDim.x)
      u2[a] = __double2float_rn(__ldg(p.u_rowsum + (a < norb ? a : a - norb)));
  __syncthreads();
  auto rd = [&](int i) { return SMEM_R2 ? sm[i] : __ldg(p.r2 + i); };
  for (int a = threadIdx.x; a < n2; a += blockDim.x) {
    float c = 0.f;
    for (int q = 0; q < n2; ++q) c = __fadd_rn(c, rd(q * st + a));
    colsum[a] = c;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long slot = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       slot < p.cap; slot += stride) {
    const Det<NW> det(p.up + slot * p.n_words, p.dn + slot * p.n_words,
                      p.n_words, norb);
    const double u_pick = __ldg(p.u_pick + slot);
    const double u_entry = __ldg(p.u_entry + slot);
    int ne = 0;
#pragma unroll
    for (int i = 0; i < det.words(); ++i) ne += __popcll(det.word(i));

    Sel r;
    bool done = false;
    if constexpr (NW > 0) {
      if (ne <= REG_NE) {
        r = select_regs<REG_NE>(det, ne, rd, st, u2, n2, singles, u_pick,
                                u_entry);
        done = true;
      }
    }
    if (!done && ne == n2) {
      // every spin-orbital occupied: the walk's empty-slot sentinel (all
      // bits set) past the spawn total, a share of every generation's slots
      const AllSeq seq{n2};
      r = select_slot(seq, [&](int a, int) { return colsum[a]; }, rd, st, u2,
                      n2, singles, u_pick, u_entry);
      done = true;
    }
    if (!done) {
      const BitSeq<NW> seq{det};
      auto mu = [&](int a, int) {
        return total(seq, [&](int q, int) { return rd(q * st + a); });
      };
      r = select_slot(seq, mu, rd, st, u2, n2, singles, u_pick, u_entry);
    }

    p.o1[slot] = r.o1;
    p.o2[slot] = r.o2;
    p.m_tot[slot] = r.m_tot;
    p.s1q[slot] = r.s1q;
    p.s2q[slot] = r.s2q;
    p.p_pair[slot] = r.p_pair;
    if (singles) {
      p.o_s[slot] = r.o_s;
      p.utot[slot] = r.utot;
      p.c_s[slot] = r.c_s;
    }
  }
}

int opt_in_bytes(int dev) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// The kernel for these shapes: the register path holds one word a spin
// (2n <= 128: R2 always fits in shared memory); any other shape
// recomputes mu.  Both compute the same function for any det.
const void* kernel_of(int n_words, bool smem_r2) {
  if (n_words == 1 && smem_r2) return (const void*)k_hb_select<1, true>;
  return smem_r2 ? (const void*)k_hb_select<0, true>
                 : (const void*)k_hb_select<0, false>;
}

struct Plan {
  long long cap;                              // the shapes it is for
  int n_words, norb;
  const void* fn;
  bool smem_r2;
  int st, per_sm;
  long long bytes, blocks;
};

// The last plan of each device: the walk launches the same shapes every
// generation, so a launch asks the runtime nothing but its device.
constexpr int MAX_DEVICES = 64;
Plan g_plans[MAX_DEVICES];
bool g_planned[MAX_DEVICES];
std::mutex g_plan_lock;

int plan_launch(long long cap, int n_words, int norb, Plan* pl) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) {
    std::lock_guard<std::mutex> hold(g_plan_lock);
    const Plan& c = g_plans[dev];
    if (g_planned[dev] && c.cap == cap && c.n_words == n_words &&
        c.norb == norb) {
      *pl = c;
      return 0;
    }
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long n2 = 2LL * norb, odd = n2 + 1;
  pl->cap = cap;
  pl->n_words = n_words;
  pl->norb = norb;
  pl->smem_r2 = n2 * odd * 4 + 2 * n2 * 4 <= opt_in_bytes(dev);
  pl->st = (int)(pl->smem_r2 ? odd : n2);
  pl->bytes = (pl->smem_r2 ? n2 * odd * 4 : 0) + 2 * n2 * 4;
  pl->fn = kernel_of(n_words, pl->smem_r2);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl->per_sm, pl->fn,
                                                    THREADS,
                                                    (size_t)pl->bytes);
  if (e != cudaSuccess) return (int)e;
  // one wave of resident blocks, each looping over its slots
  const long long want = (cap + THREADS - 1) / THREADS;
  const long long resident = (long long)(pl->per_sm > 0 ? pl->per_sm : 1) * sms;
  pl->blocks = want > resident ? resident : want;
  if (pl->blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dev < MAX_DEVICES) {
    std::lock_guard<std::mutex> hold(g_plan_lock);
    g_plans[dev] = *pl;
    g_planned[dev] = true;
  }
  return 0;
}

}  // namespace

// Lets every kernel use all the shared memory a block may opt into.
// Called once per device, with that device current.
extern "C" int sqmc_hb_select_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int bytes = opt_in_bytes(dev);
  for (int w = 0; w <= 1; ++w)
    for (int s = 0; s < 2; ++s) {
      e = cudaFuncSetAttribute(kernel_of(w, s == 1),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
      if (e != cudaSuccess) return (int)e;
    }
  return 0;
}

// The launch for these shapes: out[0] blocks, out[1] threads a block,
// out[2] dynamic shared bytes a block, out[3] resident blocks per SM,
// out[4] 1 if R2 is in shared memory, out[5] registers a thread, out[6]
// local (spilled) bytes a thread, out[7] the electrons the register path
// takes (0: every det recomputes mu in each pass).
extern "C" int sqmc_hb_select_shape(long long cap, int n_words, int norb,
                                    long long* out) {
  if (cap <= 0 || norb <= 0 || n_words * 64 < norb)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  int e = plan_launch(cap, n_words, norb, &pl);
  if (e != 0) return e;
  cudaFuncAttributes attr;
  cudaError_t ce = cudaFuncGetAttributes(&attr, pl.fn);
  if (ce != cudaSuccess) return (int)ce;
  out[0] = pl.blocks;
  out[1] = THREADS;
  out[2] = pl.bytes;
  out[3] = pl.per_sm;
  out[4] = pl.smem_r2;
  out[5] = attr.numRegs;
  out[6] = (long long)attr.localSizeBytes;
  out[7] = pl.fn == (const void*)k_hb_select<1, true> ? REG_NE : 0;
  return 0;
}

// up, dn: [cap, n_words] int64 det words; r2: [2 norb, 2 norb] float32;
// u_rowsum: [norb] float64 or null (no singles: o_s, utot and c_s are not
// written); u_pick, u_entry: [cap] float64; o1, o2, o_s: [cap] int64;
// m_tot, s1q, s2q, p_pair, utot, c_s: [cap] float32.
extern "C" int sqmc_hb_select(long long cap, int n_words, int norb,
                              const void* up, const void* dn, const void* r2,
                              const void* u_rowsum, const void* u_pick,
                              const void* u_entry, void* o1, void* o2,
                              void* o_s, void* m_tot, void* s1q, void* s2q,
                              void* p_pair, void* utot, void* c_s,
                              void* stream) {
  if (cap <= 0 || norb <= 0 || n_words * 64 < norb)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  int e = plan_launch(cap, n_words, norb, &pl);
  if (e != 0) return e;
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
  a.st = pl.st;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(pl.fn, dim3((unsigned)pl.blocks),
                               dim3(THREADS), args, (size_t)pl.bytes,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* sqmc_hb_select_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
