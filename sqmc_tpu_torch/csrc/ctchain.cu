// The continuous-time chains of the exponential projector in ct_mode
// "hubbardk", for Hopper (sm_90a): K7.
//
// Replaces the hubbardk branch of sqmc_tpu/algo/walk.py:1089 `_ct_chain`
// (ref: move_uniform_exponential_projector, do_walk.f90:3803, the
// deterministic-diagonal variant), which the port ran as ct_max_jumps
// vectorized moves of torch rows over every spawn slot: per move three
// stable argsorts of [S, norb] occupancy rows for the occupied and empty
// orbital lists, a GEMM over 2 S rows for the diagonal, and the factor
// and bookkeeping rows.  A drawn chain lives for 1 + its jumps moves
// (~1.8 at hubbardk4x4.walk-ct's tau rate of 0.344) and only ~40% of
// the slots are drawn, so ~94% of that work fell on ended chains or
// empty slots.  This kernel gives the same chains, one thread a slot:
//   * a slot that is not drawn writes its parent's words, factor 0 and
//     flag false;
//   * a drawn slot keeps its det words, time, factor and jump count in
//     registers and runs moves i = 0, 1, ... until its time crosses tau,
//     its proposal dies (s occupied) or it has made n_moves moves, reading
//     only u[i][k][slot], k = 0..3 (coalesced across the warp; move i + 1's
//     loaded while move i runs, so no move waits on memory): the time
//     -log(max(u0, TINY)) / rate, wrapped on move 0 by fmod(., tau) and
//     the sign fix-up torch.remainder makes; the segment factor
//     exp(seg ((E_T - H_ii) + rate)); unless it crossed, p, q and r by a
//     select on the words (popcounts of halves, no sort), s from kmap3,
//     the sign from the popcounts of the two windows, the next det;
//   * H_ii is slater.diag_elements' formula over the det's occupied
//     orbitals in double: E_core + sum h_pp + 1/2 (uDu - sum_u D_pp) +
//     1/2 (dDd - sum_d D_pp) + uDd - 1/2 (uXu - sum_u D_pp) - 1/2 (dXd -
//     sum_d D_pp), summed in another order than the GEMM's (the factor
//     differs from the plain version's in its last bits only);
//   * a chain still running after n_moves moves is zeroed; each block
//     sums its jumps and its cut chains and adds each with one atomic
//     into the two float64 counters (integers: exact in any order).
// Times, crossings, words, flags and counters are the plain version's
// bits: the same double ops in the same order (log, exp and fmod are the
// functions torch's CUDA ops call; no sum or product here can contract
// into an fma).  rate, tau and E_T are read from their device scalars, so
// the launch can be captured in a CUDA graph; the kernel allocates
// nothing and does not sync.
//
// What bounds it: the latency of each warp's longest chain, not bytes.
// Its compulsory bytes are 41 a drawn slot at one word a spin (parent
// words in, child words, factor and flag out): at the cell's ~105,900
// drawn slots 4.4 MB, 1.3 us at 3.35 TB/s; a move is a dependent chain of
// global loads, log, exp, a ~100-term diagonal and bit scans.
//
// Design: grid-stride over the slots, at most the blocks that fit on the
// card at once.  h_pp, the direct and exchange tables and kmap3 are read
// through L1 (6 KB and 32 KB at the cell's 16 orbitals).  One and two
// words a spin (norb <= 128).
//
// Measured (chip_smoke.py phase 2g, NVIDIA H100 80GB HBM3, 700.00 W;
// device us a call in a CUDA graph): 75.3 us at hubbardk4x4.walk-ct's
// shape (262,144 slots, 104,857 drawn, 12 moves; share 0.017 of the
// 1.29 us bound), 73 registers and no spills a thread, three blocks of
// 256 an SM; the torch moves it replaced took 42,764 us.  The time is
// the FP64 work of the warps' longest chains (log, exp and the diagonal,
// every lane of a warp waiting for its longest), not memory: loading each
// next move's uniforms early took 3.6 us off it.  Staging the tables in
// shared memory (kmap3 as bytes) made it 7.5% faster alone, 6-9 us of the
// walk's 1.39 ms generation, under the cell's run-to-run spread, so the
// tables stay where they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr double TINY = 1e-30;                // ops/ctchain.py TINY

typedef unsigned long long u64;

struct Args {
  long long S;
  int norb, nup, ndn, n_moves;
  double core;
  const double* u;                            // [n_moves][6][S]
  const u64* up_w;                            // [S][NW]
  const u64* dn_w;
  const uint8_t* valid;                       // [S]
  const double* h;                            // [norb][norb]
  const double* direct;
  const double* exch;
  const long long* kmap3;                     // [norb^3]
  const double* rate;                         // 0-d
  const double* tau;
  const double* e_trial;
  u64* up_out;
  u64* dn_out;
  double* f_out;
  uint8_t* ok_out;
  double* counts;                             // [2]: jumps, cut chains
};

// Position of the k-th (from 0) set bit of x; x has more than k set bits.
__device__ __forceinline__ int select64(u64 x, int k) {
  int pos = 0;
  int c = __popc((unsigned)x);
  if (k >= c) { k -= c; x >>= 32; pos = 32; }
  c = __popc((unsigned)x & 0xffffu);
  if (k >= c) { k -= c; x >>= 16; pos += 16; }
  c = __popc((unsigned)x & 0xffu);
  if (k >= c) { k -= c; x >>= 8; pos += 8; }
  c = __popc((unsigned)x & 0xfu);
  if (k >= c) { k -= c; x >>= 4; pos += 4; }
  c = __popc((unsigned)x & 0x3u);
  if (k >= c) { k -= c; x >>= 2; pos += 2; }
  if (k >= (int)(x & 1u)) pos += 1;
  return pos;
}

template <int NW>
__device__ __forceinline__ int select_bit(const u64 (&w)[NW], int k) {
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
    const int c = __popcll(w[i]);
    if (k < c) return 64 * i + select64(w[i], k);
    k -= c;
  }
  return 64 * (NW - 1) + select64(w[NW - 1], k);
}

__device__ __forceinline__ u64 mask_lt(int x) {     // bits < x, x in [0, 64]
  return x >= 64 ? ~0ull : ((1ull << x) - 1ull);
}

// Set bits of w at positions in [a, b), a <= b.
template <int NW>
__device__ __forceinline__ int count_in(const u64 (&w)[NW], int a, int b) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int lo = min(max(a - 64 * i, 0), 64);
    const int hi = min(max(b - 64 * i, 0), 64);
    n += __popcll(w[i] & (mask_lt(hi) ^ mask_lt(lo)));
  }
  return n;
}

template <int NW>
__device__ __forceinline__ bool bit_of(const u64 (&w)[NW], int o) {
  bool on = false;                            // no dynamic index: registers
#pragma unroll
  for (int i = 0; i < NW; ++i)
    if ((o >> 6) == i) on = (w[i] >> (o & 63)) & 1ull;
  return on;
}

template <int NW>
__device__ __forceinline__ void flip_bit(u64 (&w)[NW], int o) {
#pragma unroll
  for (int i = 0; i < NW; ++i)
    if ((o >> 6) == i) w[i] ^= 1ull << (o & 63);
}

// Calls fn(p) for each set bit p of w, ascending.
template <int NW, typename F>
__device__ __forceinline__ void for_bits(const u64 (&w)[NW], F fn) {
#pragma unroll
  for (int i = 0; i < NW; ++i)
    for (u64 x = w[i]; x; x &= x - 1ull)
      fn(64 * i + __ffsll((long long)x) - 1);
}

template <int NW>
__device__ double diag_of(const u64 (&cu)[NW], const u64 (&cd)[NW],
                          const Args& a) {
  const int n = a.norb;
  auto hpp = [&](int p) { return __ldg(a.h + p * (n + 1)); };
  auto d = [&](int p, int q) { return __ldg(a.direct + p * n + q); };
  auto x = [&](int p, int q) { return __ldg(a.exch + p * n + q); };
  double hs = 0.0, uDu = 0.0, uXu = 0.0, uDd = 0.0, uDp = 0.0;
  double dDd = 0.0, dXd = 0.0, dDp = 0.0;
  for_bits(cu, [&](int p) {
    hs += hpp(p);
    uDp += d(p, p);
    for_bits(cu, [&](int q) { uDu += d(p, q); uXu += x(p, q); });
    for_bits(cd, [&](int q) { uDd += d(p, q); });
  });
  for_bits(cd, [&](int p) {
    hs += hpp(p);
    dDp += d(p, p);
    for_bits(cd, [&](int q) { dDd += d(p, q); dXd += x(p, q); });
  });
  const double direct = 0.5 * (uDu - uDp) + 0.5 * (dDd - dDp) + uDd;
  const double exch = -0.5 * (uXu - uDp) - 0.5 * (dXd - dDp);
  return a.core + hs + direct + exch;
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
k_ct_chain(const Args a) {
  __shared__ unsigned red[2][WARPS];
  const int norb = a.norb, t = threadIdx.x;
  const double rate = *a.rate, tau = *a.tau, et = *a.e_trial;
  const long long S = a.S;
  const int nup = a.nup, ndn = a.ndn, nemp = norb - nup;
  u64 umask[NW];                              // the norb orbitals' bits
#pragma unroll
  for (int i = 0; i < NW; ++i) umask[i] = mask_lt(min(max(norb - 64 * i, 0), 64));

  unsigned my_jumps = 0, my_cut = 0;
  for (long long slot = (long long)blockIdx.x * THREADS + t; slot < S;
       slot += (long long)gridDim.x * THREADS) {
    u64 cu[NW], cd[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      cu[i] = __ldg(a.up_w + slot * NW + i);
      cd[i] = __ldg(a.dn_w + slot * NW + i);
    }
    double f = 0.0;
    if (a.valid[slot]) {
      f = 1.0;
      double tm = 0.0;
      bool done = false;
      // move i's four uniforms, loaded while move i - 1 runs
      const double* ui = a.u + slot;
      double nxt[4] = {__ldg(ui), __ldg(ui + S), __ldg(ui + 2 * S),
                       __ldg(ui + 3 * S)};
      for (int i = 0; i < a.n_moves; ++i) {
        const double u0 = nxt[0], u1 = nxt[1], u2 = nxt[2], u3 = nxt[3];
        if (i + 1 < a.n_moves) {
          ui += 6 * S;
#pragma unroll
          for (int k = 0; k < 4; ++k) nxt[k] = __ldg(ui + k * S);
        }
        double t_inc = -log(u0 < TINY ? TINY : u0) / rate;
        if (i == 0) {                         // torch.remainder(t_inc, tau)
          double m = fmod(t_inc, tau);
          if (m != 0.0 && ((tau < 0.0) != (m < 0.0))) m += tau;
          t_inc = m;
        }
        const double t_new = tm + t_inc;
        const bool cross = t_new > tau;
        const double hii = diag_of<NW>(cu, cd, a);
        const double seg = cross ? tau - tm : t_inc;
        const double seg_f = exp(seg * ((et - hii) + rate));
        if (cross) {
          f = f * seg_f * 1.0;
          done = true;
          break;
        }
        const int k1 = min((int)(long long)(u1 * (double)nup), nup - 1);
        const int k2 = min((int)(long long)(u2 * (double)ndn), ndn - 1);
        const int k3 = min((int)(long long)(u3 * (double)nemp), nemp - 1);
        u64 emp[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) emp[w] = ~cu[w] & umask[w];
        // min: a det with too few bits (not a walker) stays in the tables
        const int p = min(select_bit(cu, k1), norb - 1);
        const int q = min(select_bit(cd, k2), norb - 1);
        const int r = min(select_bit(emp, k3), norb - 1);
        const int s = (int)__ldg(a.kmap3 + (p * norb + q) * norb + r);
        if (bit_of(cd, s)) {                  // the proposal dies
          f = f * seg_f * 0.0;
          done = true;
          break;
        }
        const int n = count_in(cu, min(p, r), max(p, r)) - (p < r)
                      + count_in(cd, min(q, s), max(q, s)) - (q < s);
        f = f * seg_f * ((n % 2 == 0) ? -1.0 : 1.0);
        flip_bit(cu, p);
        flip_bit(cu, r);
        flip_bit(cd, q);
        flip_bit(cd, s);
        ++my_jumps;
        tm = t_new;
      }
      if (!done) {
        f = 0.0;
        ++my_cut;
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      a.up_out[slot * NW + i] = cu[i];
      a.dn_out[slot * NW + i] = cd[i];
    }
    a.f_out[slot] = f;
    a.ok_out[slot] = a.valid[slot] && f != 0.0;
  }

  my_jumps = __reduce_add_sync(0xffffffffu, my_jumps);
  my_cut = __reduce_add_sync(0xffffffffu, my_cut);
  if (t % 32 == 0) {
    red[0][t / 32] = my_jumps;
    red[1][t / 32] = my_cut;
  }
  __syncthreads();
  if (t < 2) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[t][w];
    if (s != 0) atomicAdd(a.counts + t, (double)s);
  }
}

typedef void (*Kernel)(const Args);

Kernel kernel_of(int nw) { return nw == 1 ? k_ct_chain<1> : k_ct_chain<2>; }

constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES];                       // SMs of each device

int current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  if (*dev < 0 || *dev >= MAX_DEVICES || g_sms[*dev] == 0)
    return (int)cudaErrorInitializationError;     // init not run here
  return 0;
}

int valid_shape(long long S, int nw, int norb) {
  if (S <= 0 || S >= (1ll << 31) || nw < 1 || nw > 2 || norb <= 64 * (nw - 1)
      || norb > 64 * nw)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// blocks and resident blocks of a launch
int shape_of(long long S, int nw, int dev, long long* out) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_of(nw), THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (S + THREADS - 1) / THREADS;
  const long long most = (long long)g_sms[dev] * per_sm;
  out[0] = want < most ? want : most;
  out[1] = THREADS;
  out[2] = per_sm;
  return 0;
}

}  // namespace

// The current device's SM count.
extern "C" int sqmc_ct_chain_init() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  e = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// The launch for S slots of nw words a spin over norb orbitals: out[0]
// blocks, out[1] threads a block, out[2] resident blocks per SM.
extern "C" int sqmc_ct_chain_shape(long long S, int nw, int norb,
                                   long long* out) {
  int err = valid_shape(S, nw, norb);
  if (err != 0) return err;
  int dev = 0;
  err = current_device(&dev);
  if (err != 0) return err;
  return shape_of(S, nw, dev, out);
}

// ins: u [n_moves][6][S] double, up_w and dn_w [S][nw] int64, slot_valid
// [S] bytes, h, direct and exchange [norb][norb] double, kmap3 [norb^3]
// int64 (each entry in [0, norb)), rate, tau and e_trial 0-d double.
// outs: up and dn [S][nw] int64, f [S] double, ok [S] bytes, counts [2]
// double (zeroed by the caller; jumps and cut chains are added).
extern "C" int sqmc_ct_chain(long long S, int nw, int norb, int nup, int ndn,
                             int n_moves, double core, void** ins,
                             void** outs, void* stream) {
  int err = valid_shape(S, nw, norb);
  if (err != 0) return err;
  if (nup < 1 || nup >= norb || ndn < 1 || ndn > norb || n_moves < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  err = current_device(&dev);
  if (err != 0) return err;
  long long shape[3];
  err = shape_of(S, nw, dev, shape);
  if (err != 0) return err;
  Args a;
  a.S = S; a.norb = norb; a.nup = nup; a.ndn = ndn; a.n_moves = n_moves;
  a.core = core;
  a.u = static_cast<const double*>(ins[0]);
  a.up_w = static_cast<const u64*>(ins[1]);
  a.dn_w = static_cast<const u64*>(ins[2]);
  a.valid = static_cast<const uint8_t*>(ins[3]);
  a.h = static_cast<const double*>(ins[4]);
  a.direct = static_cast<const double*>(ins[5]);
  a.exch = static_cast<const double*>(ins[6]);
  a.kmap3 = static_cast<const long long*>(ins[7]);
  a.rate = static_cast<const double*>(ins[8]);
  a.tau = static_cast<const double*>(ins[9]);
  a.e_trial = static_cast<const double*>(ins[10]);
  a.up_out = static_cast<u64*>(outs[0]);
  a.dn_out = static_cast<u64*>(outs[1]);
  a.f_out = static_cast<double*>(outs[2]);
  a.ok_out = static_cast<uint8_t*>(outs[3]);
  a.counts = static_cast<double*>(outs[4]);
  kernel_of(nw)<<<(unsigned)shape[0], THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* sqmc_ct_chain_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
