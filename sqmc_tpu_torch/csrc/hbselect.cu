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
#include <type_traits>

namespace {

constexpr int THREADS = 256;                  // slots (threads) a block
constexpr int MINBLOCKS = 4;                  // resident blocks ptxas plans for
constexpr int SPAWN_MINBLOCKS = 3;            // the same for K3b
constexpr int REG_NE = 16;                    // electrons the register path takes
constexpr float TINY = 1e-30f;                // the walk's TINY in float32

// What the selection reads.
struct SelIn {
  const unsigned long long* up;               // [cap, n_words] det words
  const unsigned long long* dn;
  const float* r2;                            // [n2, n2]
  const double* u_rowsum;                     // [norb], nullptr: no singles
  const double* u_pick;                       // [cap] o1 / o_s stream
  const double* u_entry;                      // [cap] o2 stream
  long long cap;
  int n_words, norb, n2;
  int st;                                     // R2's row stride as read
};

// K3's launch: the selection and where it is written.
struct Args {
  SelIn in;
  long long* o1;
  long long* o2;
  long long* o_s;
  float* m_tot;
  float* s1q;
  float* s2q;
  float* p_pair;
  float* utot;
  float* c_s;
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

// Every slot of the launch with its selection.  The block's preamble puts
// R2 (at row stride st, SMEM_R2), the singles weights u(a mod n) in
// float32 and R2's column sums (mu of a det with every spin-orbital
// occupied) in shared memory; then each thread takes its slots and calls
// each(slot, sel).  NW = 1: one word a spin, dets of up to REG_NE
// electrons on the register path; NW = 0: any det, mu recomputed in each
// pass.  K3 writes the selection; K3b goes on to the spawn.
template <int NW, bool SMEM_R2, typename Each>
__device__ __forceinline__ void for_each_selection(const SelIn& p, Each each) {
  extern __shared__ float sm[];
  const int n2 = p.n2, norb = p.norb, st = p.st;
  const bool singles = p.u_rowsum != nullptr;

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
    each(slot, r);
  }
}

template <int NW, bool SMEM_R2>
__global__ void __launch_bounds__(THREADS, MINBLOCKS) k_hb_select(Args p) {
  for_each_selection<NW, SMEM_R2>(p.in, [&](long long slot, const Sel& r) {
    p.o1[slot] = r.o1;
    p.o2[slot] = r.o2;
    p.m_tot[slot] = r.m_tot;
    p.s1q[slot] = r.s1q;
    p.s2q[slot] = r.s2q;
    p.p_pair[slot] = r.p_pair;
    if (p.in.u_rowsum != nullptr) {
      p.o_s[slot] = r.o_s;
      p.utot[slot] = r.utot;
      p.c_s[slot] = r.c_s;
    }
  });
}

// ---------------------------------------------------------------------------
// K3b, the heat-bath proposal of each slot (sqmc_hb_spawn)
// ---------------------------------------------------------------------------
//
// After the selection above, one thread finishes its slot in registers,
// in the op order of the plain version (ops/hbspawn.py `propose_plain`),
// and writes the child's words, its spawn factor and whether it spawns:
//
//   p_single  = utot / (utot + m_tot / 2) (0 without singles, or when the
//               sum is not > 0), in the state's precision; a single when
//               u_b < p_single
//   double    the pair (o1, o2) as (pp, qq) with its spin case, the row rc
//               of the heat-bath table, an in-row slot from u_r and the
//               accept-or-alias target (r, s) from u_a2; occupancy of r, s
//               and the sign by popcount over the windows, per word;
//               factor = -tau sign(H) S_rc / max((1 - p_single) p_pair,
//               TINY), 0 where the pair failed
//   single    the occupied spin-orbital o_s, its target by the singles
//               alias row from u_e and u_a2, the sign, the element h_pr +
//               sum over the same spin's occupied q != p, r of (pr|qq) -
//               (pq|qr) + sum over the other spin's of (pr|qq), added in
//               ascending q from sng_pack's float32 row (PACK) or the
//               float64 tables (ROWS); factor = -tau H / max(p_single
//               U_pr / utot, TINY) * S_p / c_s
//
// Every product, quotient and sum is one IEEE rounding (the _rn
// intrinsics: nothing contracts into an FMA) in the type torch promotes
// the plain version's operands to: tau is a 0-d float64 tensor, so it
// takes the type of the [CAP] operand it meets; a float32 row times a
// float64 one is float64.  The factor is float64, as the plain version's.
// So the doubles' factor, the words and the flags are the plain
// version's bits; the singles' element differs only by the order of its
// two row sums (torch reduces them in its own order).
//
// What bounds it: bytes and latency.  A slot reads its det words (16 W
// B), five float64 uniforms (40 B), a row of the heat-bath table (20 B)
// and an alias cell with its two codes (12 B), and writes its words, its
// factor and its flag (16 W + 9 B): 113 B at one word a spin, 29.6 MB at
// CAP = 262,144 (8.8 us at 3.35 TB/s); a single reads its alias cell, S_p
// and up to ne + 2 cells of its singles row besides.  The table reads are
// scattered but small: the tables live in L2.  Measured (the benchmark's
// traced runs, NVIDIA H100 80GB HBM3, 700 W): 64.5 us a generation at
// c2.walk's 262,144 slots, 7.3x that bound, against K3's 39 us alone;
// latency and instruction throughput, as for K3, not bytes.

enum SinglesSource { NO_SINGLES = 0, PACK = 1, ROWS = 2 };

struct SpawnArgs {
  SelIn in;                                   // u_pick: up_, u_entry: ue
  const double* ub;                           // [cap] single-or-double stream
  const double* ua2;                          // [cap] alias stream
  const double* ur;                           // [cap] in-row slot stream
  const double* tau;                          // [] the walk's tau
  const float* hb_alias_q;                    // [n_cat]
  const float* hb_rs_own;                     // [n_cat] sign(H) (r norb + s + 1)
  const float* hb_rs_partner;                 // [n_cat]
  const long long* hb_start;                  // [rows]
  const long long* hb_count;                  // [rows]
  const float* hb_rowsum;                     // [rows]
  const float* u_alias_q;                     // [norb^2]
  const long long* u_alias_J;                 // [norb^2]
  const float* sng_pack;                      // PACK: [norb^2, 2 norb + 2]
  const double* h;                            // ROWS: [norb, norb]
  const double* sing_dir;                     // ROWS: [norb^2, norb]
  const double* sing_exch;                    // ROWS: [norb^2, norb]
  const double* u_table;                      // ROWS: [norb, norb]
  unsigned long long* su;                     // [cap, n_words]
  unsigned long long* sd;                     // [cap, n_words]
  double* fac;                                // [cap]
  bool* ok;                                   // [cap]
  long long n_cat;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// x.clamp(min=1e-30) in x's type (NaN stays NaN)
template <typename T>
__device__ __forceinline__ T clamp_tiny(T x) {
  const T t = (T)1e-30;
  return x < t ? t : x;
}

// One spin's det words as the walk hands them (bits past norb kept): one
// word in a register (NW = 1), else read through L1.
template <int NW>
struct Words {
  const unsigned long long* p;
  unsigned long long w0;
  int n;
  __device__ __forceinline__ Words(const unsigned long long* p_, int W)
      : p(p_), w0(0ull), n(NW > 0 ? NW : W) {
    if (NW > 0) w0 = __ldg(p_);
  }
  __device__ __forceinline__ unsigned long long operator[](int k) const {
    return NW > 0 ? w0 : __ldg(p + k);
  }
};

// word k of dets._bit_words(W, orb): one word takes bit orb mod 64 whatever
// the word index; several words take it in word floor(orb / 64) only
__device__ __forceinline__ unsigned long long bit_in(long long orb, int k,
                                                     int W) {
  const unsigned long long b = 1ull << (orb & 63);
  return (W == 1 || (orb >> 6) == k) ? b : 0ull;
}

template <int NW>
__device__ __forceinline__ bool get_orb(const Words<NW>& w, long long orb) {
  unsigned long long on = 0ull;
  for (int k = 0; k < w.n; ++k) on |= w[k] & bit_in(orb, k, w.n);
  return on != 0ull;
}

// dets.count_below: set bits at positions in [min(lo, hi), max(lo, hi))
__device__ __forceinline__ unsigned long long mask_lt(long long x) {
  x = x < 0 ? 0 : x > 64 ? 64 : x;
  return x >= 64 ? ~0ull : (1ull << x) - 1ull;
}

template <int NW>
__device__ __forceinline__ int count_below(const Words<NW>& w, long long lo,
                                           long long hi) {
  const long long a = lo < hi ? lo : hi, b = lo < hi ? hi : lo;
  int c = 0;
  for (int k = 0; k < w.n; ++k)
    c += __popcll(w[k] & (mask_lt(b - 64 * k) ^ mask_lt(a - 64 * k)));
  return c;
}

__device__ __forceinline__ int in_window(long long x, long long a,
                                         long long b) {
  return x >= (a < b ? a : b) && x < (a < b ? b : a);
}

__device__ __forceinline__ double parity_sign(int n) {
  return (n & 1) ? -1.0 : 1.0;
}

// floor division and the non-negative remainder, as torch's // and %
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// calls f(q) for each occupied orbital q < norb of one spin, ascending
template <int NW, typename F>
__device__ __forceinline__ void each_occupied(const Words<NW>& w, int norb,
                                              F f) {
  for (int k = 0; k < w.n; ++k) {
    const int left = norb - 64 * k;
    if (left <= 0) break;
    unsigned long long m = w[k];
    if (left < 64) m &= (1ull << left) - 1ull;
    while (m) {
      f(64 * k + __ffsll((long long)m) - 1);
      m &= m - 1ull;
    }
  }
}

// A move of one spin's words: clear c1, c2, then set s1, s2 (a single
// repeats its orbitals); `on` false leaves the words as they are.
struct Move {
  bool on;
  long long c1, c2, s1, s2;
  __device__ __forceinline__ unsigned long long word(unsigned long long x,
                                                     int k, int W) const {
    if (!on) return x;
    return (x & ~(bit_in(c1, k, W) | bit_in(c2, k, W))) | bit_in(s1, k, W) |
           bit_in(s2, k, W);
  }
};

// The single's element without its sign, in the precision of its rows:
// h_pr + sum over the same spin's occupied q != p, r of (pr|qq) - (pq|qr)
// + sum over the other spin's of (pr|qq), each sum in ascending q; and
// U[p, r].
template <int SRC, int NW, typename U>
__device__ __forceinline__ U single_element(const SpawnArgs& p, int norb,
                                            long long ps, long long rs,
                                            const Words<NW>& same,
                                            const Words<NW>& other,
                                            U* u_sel) {
  const long long cell = ps * norb + rs;
  const U* dir;
  const U* exch;
  U h;
  if constexpr (SRC == PACK) {
    const float* row = p.sng_pack + cell * (2 * norb + 2);
    dir = row;
    exch = row + norb;
    h = __ldg(row + 2 * norb);
    *u_sel = __ldg(row + 2 * norb + 1);
  } else {
    dir = p.sing_dir + cell * norb;
    exch = p.sing_exch + cell * norb;
    h = __ldg(p.h + cell);
    *u_sel = __ldg(p.u_table + cell);
  }
  U s1 = 0, s2 = 0;
  each_occupied(same, norb, [&](int q) {
    if (q != ps && q != rs) s1 = add_rn(s1, sub_rn(__ldg(dir + q), __ldg(exch + q)));
  });
  each_occupied(other, norb, [&](int q) { s2 = add_rn(s2, __ldg(dir + q)); });
  return add_rn(add_rn(h, s1), s2);
}

// The rest of the proposal of one slot after its selection r.
template <typename WT, int SRC, int NW>
__device__ __forceinline__ void spawn_slot(const SpawnArgs& p, long long slot,
                                           const Sel& r) {
  // p_single's type: the state's with singles; without, float64 (the plain
  // version's zeros are float64)
  using PS = typename std::conditional<SRC == NO_SINGLES, double, WT>::type;
  const int norb = p.in.norb, W = NW > 0 ? NW : p.in.n_words;
  const Words<NW> up(p.in.up + slot * W, W), dn(p.in.dn + slot * W, W);
  const double tau = __ldg(p.tau);
  const double ua2 = __ldg(p.ua2 + slot);

  PS psing = 0;
  if constexpr (SRC != NO_SINGLES) {
    const WT ut = (WT)r.utot, w2 = (WT)__fmul_rn(0.5f, r.m_tot);
    const WT sum = add_rn(ut, w2);
    psing = sum > (WT)0 ? div_rn(ut, sum) : (WT)0;
  }
  const bool single = SRC != NO_SINGLES && __ldg(p.ub + slot) < (double)psing;

  Move mv_up{false, 0, 0, 0, 0}, mv_dn{false, 0, 0, 0, 0};
  double fac = 0.0;
  bool ok = false;
  if (!single) {
    const int o1 = r.o1, o2 = r.o2;
    const bool fail = o1 == o2 || r.m_tot <= 0.f || r.s1q <= 0.f ||
                      r.s2q <= 0.f || r.p_pair <= 0.f;
    const bool up1 = o1 < norb, up2 = o2 < norb;
    const long long orb1 = up1 ? o1 : o1 - norb, orb2 = up2 ? o2 : o2 - norb;
    const bool same_up = up1 && up2, opp = up1 != up2;
    // opposite spins: pp the up orbital, qq the dn one; same spin: pp < qq
    const long long pp = opp ? (up1 ? orb1 : orb2) : (orb1 < orb2 ? orb1 : orb2);
    const long long qq = opp ? (up1 ? orb2 : orb1) : (orb1 < orb2 ? orb2 : orb1);
    const long long a_s = pp < qq ? pp : qq, b_s = pp < qq ? qq : pp;
    const long long ntri = (long long)norb * (norb - 1) / 2;
    const long long rc = opp ? ntri + b_s * (b_s + 1) / 2 + a_s
                             : b_s * (b_s - 1) / 2 + a_s;
    const long long st = __ldg(p.hb_start + rc), cnt = __ldg(p.hb_count + rc);
    const float s_exact = __ldg(p.hb_rowsum + rc);
    // O(1) in-row target: a uniform slot, then accept-or-alias
    long long k = (long long)__dmul_rn(__ldg(p.ur + slot), (double)cnt);
    const long long last = cnt - 1 > 0 ? cnt - 1 : 0;
    k = k < last ? k : last;
    long long i0 = st + k;
    i0 = i0 < 0 ? 0 : i0 > p.n_cat - 1 ? p.n_cat - 1 : i0;
    const float rv = __double2float_rn(ua2) < __ldg(p.hb_alias_q + i0)
                         ? __ldg(p.hb_rs_own + i0)
                         : __ldg(p.hb_rs_partner + i0);
    const long long rs = (long long)fabsf(rv) - 1;
    const long long r_tab = floor_div(rs, norb), s_tab = rs - r_tab * norb;
    const bool swp = opp && pp > qq;
    const long long ro = swp ? s_tab : r_tab, so = swp ? r_tab : s_tab;

    const bool r_occ = (opp || same_up) ? get_orb(up, ro) : get_orb(dn, ro);
    const bool s_occ = (opp || !same_up) ? get_orb(dn, so) : get_orb(up, so);
    ok = !(r_occ || s_occ);
    int n;
    if (opp) {
      n = count_below(up, pp, ro) - in_window(pp, pp, ro) +
          count_below(dn, qq, so) - in_window(qq, qq, so);
    } else {
      const Words<NW> ws = same_up ? up : dn;
      n = count_below(ws, pp, ro) - in_window(pp, pp, ro) -
          in_window(qq, pp, ro) + count_below(ws, qq, so) -
          in_window(pp, qq, so) - in_window(qq, qq, so);
    }
    const double hv = parity_sign(n) * (double)rv;
    const double sgn = (double)((hv > 0.0) - (hv < 0.0));
    const PS den = clamp_tiny<PS>(mul_rn(sub_rn((PS)1, psing),
                                         (PS)(WT)r.p_pair));
    fac = fail ? 0.0
               : __ddiv_rn(__dmul_rn(__dmul_rn(-tau, sgn), (double)(WT)s_exact),
                           (double)den);
    if (opp) {
      mv_up = Move{true, pp, pp, ro, ro};
      mv_dn = Move{true, qq, qq, so, so};
    } else if (same_up) {
      mv_up = Move{true, pp, qq, ro, so};
    } else {
      mv_dn = Move{true, pp, qq, ro, so};
    }
  } else if constexpr (SRC != NO_SINGLES) {
    // the single's element and U[p, r] in the precision of their rows; the
    // selection probability in the type torch promotes WT and U to
    using U = typename std::conditional<SRC == ROWS, double, float>::type;
    using PU = typename std::conditional<
        std::is_same<WT, double>::value || std::is_same<U, double>::value,
        double, float>::type;
    const bool e_up = r.o_s < norb;
    const long long ps = e_up ? r.o_s : r.o_s - norb;
    long long slot_r = (long long)__dmul_rn(__ldg(p.in.u_entry + slot),
                                            (double)norb);
    slot_r = slot_r < norb - 1 ? slot_r : norb - 1;
    const long long ia = ps * norb + slot_r;
    const long long rs = __double2float_rn(ua2) < __ldg(p.u_alias_q + ia)
                             ? slot_r
                             : __ldg(p.u_alias_J + ia);
    const Words<NW> same = e_up ? up : dn, other = e_up ? dn : up;
    const double sgn = parity_sign(count_below(same, ps, rs) - (ps < rs));
    U u_sel;
    const U hsum = single_element<SRC>(p, norb, ps, rs, same, other, &u_sel);
    const double h_sng = __dmul_rn(sgn, (double)hsum);
    const PU psel = div_rn(mul_rn((PU)psing, (PU)u_sel),
                           (PU)clamp_tiny<WT>((WT)r.utot));
    const double w_s = __ddiv_rn(__dmul_rn(-tau, h_sng),
                                 (double)clamp_tiny<PU>(psel));
    const double diff = (double)r.c_s;
    fac = diff > 0.0 ? __dmul_rn(w_s, __ddiv_rn(__ldg(p.in.u_rowsum + ps), diff))
                     : w_s;
    // a draw past the last occupied spin-orbital realizes no cell
    ok = !get_orb(same, rs) && u_sel > (U)0 && diff > 0.0 && get_orb(same, ps);
    if (e_up)
      mv_up = Move{true, ps, ps, rs, rs};
    else
      mv_dn = Move{true, ps, ps, rs, rs};
  }

  for (int k = 0; k < W; ++k) {
    p.su[slot * W + k] = mv_up.word(up[k], k, W);
    p.sd[slot * W + k] = mv_dn.word(dn[k], k, W);
  }
  p.fac[slot] = fac;
  p.ok[slot] = ok;
}

template <int NW, bool SMEM_R2, typename WT, int SRC>
__global__ void __launch_bounds__(THREADS, SPAWN_MINBLOCKS)
    k_hb_spawn(SpawnArgs p) {
  for_each_selection<NW, SMEM_R2>(p.in, [&](long long slot, const Sel& r) {
    spawn_slot<WT, SRC, NW>(p, slot, r);
  });
}

int opt_in_bytes(int dev) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// The kernels for these shapes: the register path holds one word a spin
// (2n <= 128: R2 always fits in shared memory); any other shape
// recomputes mu.  All compute the same function for any det.  K3b is
// built for the state's precision with the singles rows it has: float32
// with sng_pack or none, float64 with the float64 rows or none (nullptr:
// no such kernel).
const void* kernel_of(int n_words, bool smem_r2) {
  if (n_words == 1 && smem_r2) return (const void*)k_hb_select<1, true>;
  return smem_r2 ? (const void*)k_hb_select<0, true>
                 : (const void*)k_hb_select<0, false>;
}

template <int NW, bool SM>
const void* spawn_variant(bool f64, int src) {
  if (!f64)
    return src == NO_SINGLES ? (const void*)k_hb_spawn<NW, SM, float, NO_SINGLES>
           : src == PACK     ? (const void*)k_hb_spawn<NW, SM, float, PACK>
                             : nullptr;
  return src == NO_SINGLES ? (const void*)k_hb_spawn<NW, SM, double, NO_SINGLES>
         : src == ROWS     ? (const void*)k_hb_spawn<NW, SM, double, ROWS>
                           : nullptr;
}

const void* spawn_kernel_of(int n_words, bool smem_r2, bool f64, int src) {
  if (n_words == 1 && smem_r2) return spawn_variant<1, true>(f64, src);
  return smem_r2 ? spawn_variant<0, true>(f64, src)
                 : spawn_variant<0, false>(f64, src);
}

// kind 0: K3; 1 + 3 f64 + src: K3b
constexpr int KINDS = 7;

const void* function_of(int kind, int n_words, bool smem_r2) {
  if (kind == 0) return kernel_of(n_words, smem_r2);
  return spawn_kernel_of(n_words, smem_r2, (kind - 1) / 3 == 1, (kind - 1) % 3);
}

struct Plan {
  long long cap;                              // the shapes it is for
  int n_words, norb;
  const void* fn;
  bool smem_r2;
  int st, per_sm;
  long long bytes, blocks;
};

// The last plan of each device and kind: the walk launches the same
// shapes every generation, so a launch asks the runtime nothing but its
// device.
constexpr int MAX_DEVICES = 64;
Plan g_plans[MAX_DEVICES][KINDS];
bool g_planned[MAX_DEVICES][KINDS];
std::mutex g_plan_lock;

int plan_launch(int kind, long long cap, int n_words, int norb, Plan* pl) {
  if (cap <= 0 || norb <= 0 || n_words * 64 < norb || kind < 0 ||
      kind >= KINDS)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) {
    std::lock_guard<std::mutex> hold(g_plan_lock);
    const Plan& c = g_plans[dev][kind];
    if (g_planned[dev][kind] && c.cap == cap && c.n_words == n_words &&
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
  pl->fn = function_of(kind, n_words, pl->smem_r2);
  if (pl->fn == nullptr) return (int)cudaErrorInvalidValue;
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
    g_plans[dev][kind] = *pl;
    g_planned[dev][kind] = true;
  }
  return 0;
}

// out[0] blocks, out[1] threads a block, out[2] dynamic shared bytes a
// block, out[3] resident blocks per SM, out[4] 1 if R2 is in shared
// memory, out[5] registers a thread, out[6] local (spilled) bytes a
// thread, out[7] the electrons the register path takes (0: every det
// recomputes mu in each pass).
int shape_of(int kind, long long cap, int n_words, int norb, long long* out) {
  Plan pl;
  int e = plan_launch(kind, cap, n_words, norb, &pl);
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
  out[7] = n_words == 1 && pl.smem_r2 ? REG_NE : 0;
  return 0;
}

int launch(const Plan& pl, void* args, void* stream) {
  void* list[] = {args};
  cudaError_t e = cudaLaunchKernel(pl.fn, dim3((unsigned)pl.blocks),
                                   dim3(THREADS), list, (size_t)pl.bytes,
                                   static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

}  // namespace

// Lets every kernel use all the shared memory a block may opt into.
// Called once per device, with that device current.
extern "C" int sqmc_hb_select_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int bytes = opt_in_bytes(dev);
  for (int kind = 0; kind < KINDS; ++kind)
    for (int w = 0; w <= 1; ++w)
      for (int s = 0; s < 2; ++s) {
        const void* fn = function_of(kind, w, s == 1);
        if (fn == nullptr) continue;
        e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
        if (e != cudaSuccess) return (int)e;
      }
  return 0;
}

// K3's launch for these shapes (see shape_of).
extern "C" int sqmc_hb_select_shape(long long cap, int n_words, int norb,
                                    long long* out) {
  return shape_of(0, cap, n_words, norb, out);
}

// K3b's launch for these shapes, f64 state or not, singles source src.
extern "C" int sqmc_hb_spawn_shape(long long cap, int n_words, int norb,
                                   int f64, int src, long long* out) {
  if (src < 0 || src > 2) return (int)cudaErrorInvalidValue;
  return shape_of(1 + 3 * (f64 != 0) + src, cap, n_words, norb, out);
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
  Plan pl;
  int e = plan_launch(0, cap, n_words, norb, &pl);
  if (e != 0) return e;
  Args a;
  a.in.up = static_cast<const unsigned long long*>(up);
  a.in.dn = static_cast<const unsigned long long*>(dn);
  a.in.r2 = static_cast<const float*>(r2);
  a.in.u_rowsum = static_cast<const double*>(u_rowsum);
  a.in.u_pick = static_cast<const double*>(u_pick);
  a.in.u_entry = static_cast<const double*>(u_entry);
  a.in.cap = cap;
  a.in.n_words = n_words;
  a.in.norb = norb;
  a.in.n2 = 2 * norb;
  a.in.st = pl.st;
  a.o1 = static_cast<long long*>(o1);
  a.o2 = static_cast<long long*>(o2);
  a.o_s = static_cast<long long*>(o_s);
  a.m_tot = static_cast<float*>(m_tot);
  a.s1q = static_cast<float*>(s1q);
  a.s2q = static_cast<float*>(s2q);
  a.p_pair = static_cast<float*>(p_pair);
  a.utot = static_cast<float*>(utot);
  a.c_s = static_cast<float*>(c_s);
  return launch(pl, &a, stream);
}

// K3b.  f64: the state is float64; src: 0 no singles, 1 sng_pack (float32
// state), 2 the float64 rows (float64 state).  t: the device pointers
// in this order (23): up, dn [cap, n_words] int64; r2 [2 norb, 2 norb] f32;
// u_rowsum [norb] f64 (null without singles); the five [cap] f64
// streams ub, u_pick, ue, ua2, ur; tau [] f64; hb_alias_q, hb_rs_own,
// hb_rs_partner [n_cat] f32; hb_start, hb_count [rows] int64; hb_rowsum
// [rows] f32; u_alias_q [norb^2] f32 and u_alias_J [norb^2] int64 (null
// without singles); sng_pack [norb^2, 2 norb + 2] f32 (src 1, else null);
// then h [norb, norb], sing_dir, sing_exch [norb^2, norb] and u_table
// [norb, norb] f64 (src 2, else null).  out: su, sd [cap, n_words] int64,
// fac [cap] f64, ok [cap] bool.
extern "C" int sqmc_hb_spawn(long long cap, int n_words, int norb, int f64,
                             int src, long long n_cat,
                             const void* const* t, void* const* out,
                             void* stream) {
  if (src < 0 || src > 2 || n_cat <= 0) return (int)cudaErrorInvalidValue;
  Plan pl;
  int e = plan_launch(1 + 3 * (f64 != 0) + src, cap, n_words, norb, &pl);
  if (e != 0) return e;
  SpawnArgs a;
  a.in.up = static_cast<const unsigned long long*>(t[0]);
  a.in.dn = static_cast<const unsigned long long*>(t[1]);
  a.in.r2 = static_cast<const float*>(t[2]);
  a.in.u_rowsum = static_cast<const double*>(t[3]);
  a.ub = static_cast<const double*>(t[4]);
  a.in.u_pick = static_cast<const double*>(t[5]);
  a.in.u_entry = static_cast<const double*>(t[6]);
  a.ua2 = static_cast<const double*>(t[7]);
  a.ur = static_cast<const double*>(t[8]);
  a.tau = static_cast<const double*>(t[9]);
  a.hb_alias_q = static_cast<const float*>(t[10]);
  a.hb_rs_own = static_cast<const float*>(t[11]);
  a.hb_rs_partner = static_cast<const float*>(t[12]);
  a.hb_start = static_cast<const long long*>(t[13]);
  a.hb_count = static_cast<const long long*>(t[14]);
  a.hb_rowsum = static_cast<const float*>(t[15]);
  a.u_alias_q = static_cast<const float*>(t[16]);
  a.u_alias_J = static_cast<const long long*>(t[17]);
  a.sng_pack = static_cast<const float*>(t[18]);
  a.h = static_cast<const double*>(t[19]);
  a.sing_dir = static_cast<const double*>(t[20]);
  a.sing_exch = static_cast<const double*>(t[21]);
  a.u_table = static_cast<const double*>(t[22]);
  a.su = static_cast<unsigned long long*>(out[0]);
  a.sd = static_cast<unsigned long long*>(out[1]);
  a.fac = static_cast<double*>(out[2]);
  a.ok = static_cast<bool*>(out[3]);
  a.n_cat = n_cat;
  a.in.cap = cap;
  a.in.n_words = n_words;
  a.in.norb = norb;
  a.in.n2 = 2 * norb;
  a.in.st = pl.st;
  if ((src != 0) != (a.in.u_rowsum != nullptr)) return (int)cudaErrorInvalidValue;
  return launch(pl, &a, stream);
}

extern "C" const char* sqmc_hb_select_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
