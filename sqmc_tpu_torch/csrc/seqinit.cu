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
// What bounds it: bytes.  neq and s_wt are read once, init_row once for
// each active row (see the skip below: an inactive row's result depends
// only on the carry before it) and out is written once: 1 + 4 (8) + 4 =
// 9 (13) B a row and 4 B an active row; at the walk's merge shape
// (720,896 rows, ~139,000 active at HEG-14) 7.0 MB, 2.1 us at the H100's
// 3.35 TB/s.  What stands in the way is the serial chain of a long group.
// The walk's empty walker and spawn slots share one key, so at HEG-14 they
// form one group of ~582,000 rows, which a kernel of one thread a group
// streamed alone at ~54 ns a row: 31.5 ms a call (NVIDIA H100 80GB HBM3,
// 700 W).
//
// The skip.  A zero-weight row that does not start a group leaves acc_w as
// it is (up to the sign of a zero, which neither |acc_w| nor the test
// acc_w * w > 0 can see) and sets acc_i to
//     z(acc_w, acc_i) = (|acc_w| == 0 && acc_i != 3) ? 0 : acc_i,
// which is idempotent: a run of such rows of any length is one z, every
// row of the run outputs z of the carry of the last ACTIVE row before it
// (a group start or a row with w != 0), and the next active row combines
// with (acc_w, z(acc_w, acc_i)).  So the serial chain runs over the active
// rows alone, still in row order: the bits are the plain version's.
//
// Design: a memset and three launches, all on the caller's stream, with
// scratch sized from n by the wrapper (ops/seqinit.py); no count leaves
// the device, so the call can be captured in a CUDA graph.
//   1. k_seq_init_compact: mark, compact and walk the short groups, one
//      pass with decoupled look-back as in segscan.cu.  Each 2,048-row
//      tile (8 rows a thread) reads neq as one 8-byte load and the weights
//      as 16-byte loads, marks its active rows, counts them with __popc
//      and a block scan, and stages each active row's weight, initiator
//      and flags (start; gap: inactive rows lie between it and the
//      previous active row) in shared memory at its compacted place (the
//      initiators are read only for quads of rows that hold an active
//      row).  A ninth warp publishes the tile's
//      count and looks back for its prefix (tiles taken in ticket order,
//      one 64-bit status word a tile) while the eight others walk, each
//      thread in one loop the groups that start in its rows, from shared
//      memory: z at a gap, then the rule with round-to-nearest products
//      and sums (no contraction: the plain version's bits).  A group that
//      goes SOLO rows past its start, or past the tile's end, is left open
//      with its carry on a list for pass 2.  The tile then copies its
//      compacted rows and its results (res = acc_i, fill = z(acc_w,
//      acc_i) after each row) out contiguously; each thread writes its
//      active mask and first compacted slot (8 bytes for 8 rows) for pass
//      3, and the last tile the active count.
//   2. k_seq_init_walk: one warp an open group, over the compacted stream,
//      32 x SPAN rows a step loaded (coalesced) one step ahead.  For 32
//      rows the running weight before each row is one add a row, in
//      order, computed in every lane; each lane turns its row into a map
//      of the running initiator (a few flag bits and its initiator), and
//      the 32 maps are applied one after the other, two shuffles a row:
//      the serial chain is the adds and a few integer operations a row,
//      not a memory latency.
//   3. k_seq_init_fill: each thread reads its mask and slot and writes its
//      8 rows with two 16-byte stores: out[j] = res[slot] for an active
//      row, fill[slot] for an inactive one (slot: the compacted place of
//      the last active row at or before j).
// Every output row is written once, by pass 3; no atomics touch a value
// (the open list's order, set by an atomic, does not matter: its groups
// are independent), so every run gives the same bits.
//
// Measured (chip_smoke.py phases 2e and 2c, NVIDIA H100 80GB HBM3,
// 700.00 W; device us a call in a CUDA graph, kernel us from the
// profiler): 720,896 merge rows of short groups 24.2 us f32 (kernel 20.7),
// 26.2 f64; the walk's shape (582,030 zero-weight rows in one group,
// 126,299 active) 22.1 us (kernel 18.4); one group of 30,000 rows (26,975
// active) 1,285 us, ~48 ns an active row in the warp walk: the price of
// one initiator chain, on rows no walk of the package makes.  K5 on the
// walk's own rows: PERF.md section 6.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TILE = 2048;                    // rows a tile (passes 1, 3)
constexpr int THREADS = 256;
constexpr int ITEMS = TILE / THREADS;         // 8 consecutive rows a thread
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SOLO = 32;        // pass 1: rows a thread walks after a start
constexpr int OPEN = 64;        // room for a tile's open groups
static_assert(OPEN >= TILE / (SOLO + 2) + 1 && OPEN % WARPS == 0,
              "a tile leaves open at most one group of SOLO + 2 rows or more "
              "for every SOLO + 2 of its rows, and one at its end");
constexpr int SPAN = 4;         // pass 2: 32 x SPAN rows a warp step
constexpr int WALK_BLOCKS = 256;   // pass 2's grid, at most (one wave)
constexpr unsigned F_START = 1, F_GAP = 2;    // compacted row flags
constexpr unsigned long long ST_AGG = 1ull << 32, ST_INC = 2ull << 32;

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

// z: what any run of zero-weight rows does to the running initiator.
template <typename T>
__device__ __forceinline__ int zero_run(T acc_w, int acc_i) {
  return (abs_of(acc_w) == T(0) && acc_i != 3) ? 0 : acc_i;
}

// One active row that does not start a group, as a map of the running
// initiator x: z first where R_ZG is set (inactive rows before it, and a
// running weight of 0), then, under R_KEEP, x or max(x, ini) under R_MAX,
// else 3 if x is 3, ini under R_TAKE, 0 otherwise.  Its bits depend on the
// running weight before the row and on the row alone, so the serial chain
// through x is a few integer operations.  Where go fails the map is the
// identity.
constexpr unsigned R_KEEP = 1, R_ZG = 2, R_MAX = 4, R_TAKE = 8;

template <typename T>
__device__ __forceinline__ unsigned rule_of(bool go, T acc_w, T w, bool gap) {
  const T a = abs_of(acc_w), b = abs_of(w);
  const bool gt = b > a, eq = b == a;
  const bool same = mul_rn(acc_w, w) > T(0);
  return (!go || same || !(gt || eq) ? R_KEEP : 0u) |
         (go && gap && a == T(0) ? R_ZG : 0u) |
         (go && same ? R_MAX : 0u) | (gt ? R_TAKE : 0u);
}

// Written without branches: m, b, lo and t3 depend on the row alone, so
// the chain through x is a compare, one logical operation, a max and a
// select, and nothing keeps the compiler from loading rows ahead of it.
__device__ __forceinline__ int apply_rule(unsigned R, int ini, int x) {
  const bool keep = R & R_KEEP;
  const int m = keep && !(R & R_ZG) ? -1 : 0;
  const int b = keep || !(R & R_TAKE) ? 0 : ini;
  const int lo = keep && (R & R_MAX) ? ini : INT_MIN;
  const int t3 = keep ? max(3, lo) : 3;
  return x == 3 ? t3 : max((x & m) | b, lo);
}

// The carry through one active row that does not start a group.
template <typename T>
__device__ __forceinline__ void step(T& acc_w, int& acc_i, T w, int ini,
                                     bool gap) {
  acc_i = apply_rule(rule_of(true, acc_w, w, gap), ini, acc_i);
  acc_w = add_rn(acc_w, w);
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.b64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// This thread's ITEMS rows from `base`: weights, start flags (row 0 always
// starts a group) and active flags; rows past n are inactive (no start,
// weight 0).
template <typename T>
__device__ __forceinline__ void load_rows(const unsigned char* neq,
                                          const T* wt, long long base,
                                          long long n, T (&w)[ITEMS],
                                          unsigned& starts,
                                          unsigned& active) {
  int st[ITEMS];
  if (base + ITEMS <= n) {
    const uint2 f = __ldg(reinterpret_cast<const uint2*>(neq + base));
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      st[i] = (((i < 4 ? f.x : f.y) >> (8 * (i & 3))) & 0xffu) != 0;
    uint4 raw[ITEMS * sizeof(T) / 16];
    const uint4* p = reinterpret_cast<const uint4*>(wt + base);
#pragma unroll
    for (int j = 0; j < ITEMS * (int)sizeof(T) / 16; ++j)
      raw[j] = __ldg(p + j);
    memcpy(w, raw, sizeof(raw));
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const bool in = base + i < n;
      st[i] = in ? neq[base + i] != 0 : 0;
      w[i] = in ? wt[base + i] : T(0);
    }
  }
  if (base == 0) st[0] = 1;
  starts = active = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    starts |= (unsigned)st[i] << i;
    active |= (unsigned)(st[i] || w[i] != T(0)) << i;
  }
}

// Exclusive prefix of c over the block's first THREADS threads, and their
// total (a thread past them gets their total).
__device__ __forceinline__ int block_exclusive(int c, int* warp_sums,
                                               int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31 && warp < WARPS) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int v = warp_sums[w];
    before += w < warp ? v : 0;
    total += v;
  }
  return before + x - c;
}

// One warp: publish the tile's count, look back for its carry-in (the
// nearest inclusive prefix, plus the aggregates between), publish the
// inclusive prefix.  Status word: state << 32 | count.
__device__ void look_back(int tile, int agg, unsigned long long* status,
                          int* excl_out) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) {
      st_release(status, ST_INC | (unsigned)agg);
      *excl_out = 0;
    }
    return;
  }
  if (lane == 0) st_release(status + tile, ST_AGG | (unsigned)agg);
  int excl = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int t = pred - lane;
    unsigned long long v = ST_INC;            // before tile 0: prefix 0
    if (t >= 0) {
      while (((v = ld_acquire(status + t)) >> 32) == 0) {
      }
    }
    const unsigned inc = __ballot_sync(FULL, (v >> 32) == 2);
    const int last = inc ? __ffs(inc) - 1 : 31;
    int x = lane <= last ? (int)(v & 0xffffffffu) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
    excl += x;
    if (inc) break;
  }
  if (lane == 0) {
    st_release(status + tile, ST_INC | (unsigned)(excl + agg));
    *excl_out = excl;
  }
}

// A group that pass 1 leaves open at tile slot j, with its carry there.
template <typename T>
__device__ __forceinline__ void open_group(int j, T acc_w, int acc_i,
                                           int* n, int* slot, int* ini,
                                           T* wt) {
  const int e = atomicAdd(n, 1);
  slot[e] = j;
  ini[e] = acc_i;
  wt[e] = acc_w;
}

// ---------------------------------------------------------------------------
// Pass 1: mark, compact and walk the short groups
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS + 32)
k_seq_init_compact(const unsigned char* __restrict__ neq,
                   const T* __restrict__ wt, const int* __restrict__ ini,
                   long long n, unsigned long long* status, int* ticket,
                   int* count, T* __restrict__ cw, int* __restrict__ ci,
                   unsigned char* __restrict__ cf, int* __restrict__ res,
                   int* __restrict__ fill,
                   unsigned long long* __restrict__ thread_rows,
                   int* open_total, int* __restrict__ open_slot,
                   int* __restrict__ open_i, T* __restrict__ open_w) {
  __shared__ T sw[TILE];
  __shared__ int si[TILE];
  __shared__ int sres[TILE];
  __shared__ unsigned char sf[TILE];
  __shared__ unsigned char sdone[TILE];     // 1 walked here, 2 acc_w == 0
  __shared__ unsigned masks[THREADS];
  __shared__ int warp_sums[WARPS];
  __shared__ int s_tile, s_excl, s_open;
  __shared__ unsigned s_prev;
  __shared__ int so_slot[OPEN], so_i[OPEN];
  __shared__ T so_w[OPEN];
  if (threadIdx.x == 0) {
    s_tile = atomicAdd(ticket, 1);
    s_open = 0;
  }
  __syncthreads();
  const int tile = s_tile;
  const long long tbase = (long long)tile * TILE;
  const long long base = tbase + (long long)threadIdx.x * ITEMS;
  const bool rows = threadIdx.x < THREADS;    // the last warp looks back
  T w[ITEMS];
  unsigned starts = 0, act = 0;
  if (rows) {
    load_rows<T>(neq, wt, base, n, w, starts, act);
    masks[threadIdx.x] = act;
  }
  if (threadIdx.x == 0) {                     // the row before the tile
    const long long p = tbase - 1;
    s_prev = p <= 0 ? 1u : (unsigned)(neq[p] != 0 || wt[p] != T(0));
  }
  int total;
  const int local = block_exclusive(__popc(act), warp_sums, total);
  const unsigned prev = threadIdx.x ? masks[threadIdx.x - 1] >> (ITEMS - 1)
                                    : s_prev;
  // the initiators of the quads that hold an active row
  int ri[ITEMS];
  const bool whole = base + ITEMS <= n;
#pragma unroll
  for (int q = 0; q < ITEMS / 4; ++q) {
    if (!(act >> (4 * q) & 0xfu)) continue;
    if (whole) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(ini + base) + q);
      ri[4 * q] = v.x;
      ri[4 * q + 1] = v.y;
      ri[4 * q + 2] = v.z;
      ri[4 * q + 3] = v.w;
    } else {
#pragma unroll
      for (int i = 4 * q; i < 4 * q + 4; ++i)
        ri[i] = base + i < n ? ini[base + i] : 0;
    }
  }
  int at = local;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (!(act >> i & 1u)) continue;
    const unsigned before = i ? act >> (i - 1) & 1u : prev & 1u;
    sw[at] = w[i];
    si[at] = ri[i];
    sf[at] = (unsigned char)(starts >> i & 1u ? F_START
                                              : (before ? 0u : F_GAP));
    sdone[at++] = 0;
  }
  __syncthreads();
  if (!rows) look_back(tile, total, status, &s_excl);
  // Walk the groups that start in this thread's rows, in one pass over
  // the rows from its first (one loop, so that the warp's lanes take as
  // many steps as the longest of them, not the sum of their groups'
  // longest): a group walked SOLO rows past its start, or up to the tile's
  // end, is left open for pass 2.
  T acc_w = T(0);
  int acc_i = 0, len = 0;
  bool walking = false;
  int j = rows ? local : total;
  for (; j < total; ++j) {
    if (!walking && j >= at) break;
    const unsigned f = sf[j];
    if (f & F_START) {
      if (j >= at) break;                     // the next thread's group
      walking = true;
      len = 0;
      acc_w = sw[j];
      acc_i = si[j];
    } else {
      if (!walking) continue;                 // another thread's group
      if (len == SOLO) {
        open_group(j, acc_w, acc_i, &s_open, so_slot, so_i, so_w);
        walking = false;
        continue;
      }
      step(acc_w, acc_i, sw[j], si[j], (f & F_GAP) != 0);
      ++len;
    }
    sres[j] = acc_i;
    sdone[j] = 1 | (acc_w == T(0)) << 1;
  }
  if (walking && j == total)
    open_group(j, acc_w, acc_i, &s_open, so_slot, so_i, so_w);
  __syncthreads();
  const int excl = s_excl;
  if (threadIdx.x == 0 && tile == (int)gridDim.x - 1) *count = excl + total;
  if (rows && base < n)    // for pass 3: this thread's active mask and slot
    thread_rows[base / ITEMS] = (unsigned long long)act << 32 |
                                (unsigned)(excl + local);
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    cw[excl + k] = sw[k];
    ci[excl + k] = si[k];
    cf[excl + k] = sf[k];
    const unsigned d = sdone[k];
    if (d) {
      res[excl + k] = sres[k];
      fill[excl + k] = (d & 2u) && sres[k] != 3 ? 0 : sres[k];
    }
  }
  if (threadIdx.x < 32) {           // the open groups, to pass 2's list
    int first = 0;
    if (threadIdx.x == 0 && s_open) first = atomicAdd(open_total, s_open);
    first = __shfl_sync(FULL, first, 0);
    for (int e = threadIdx.x; e < s_open; e += 32) {
      open_slot[first + e] = excl + so_slot[e];
      open_i[first + e] = so_i[e];
      open_w[first + e] = so_w[e];
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: walk the compacted stream
// ---------------------------------------------------------------------------

// Rows j, j + 32, ..., j + 32 (SPAN - 1) of the compacted stream (rows
// past cnt read as group starts: they end the walk).
template <typename T>
__device__ __forceinline__ void stage(int j, int cnt, const T* cw,
                                      const int* ci, const unsigned char* cf,
                                      T (&w)[SPAN], int (&r)[SPAN],
                                      unsigned (&f)[SPAN]) {
#pragma unroll
  for (int v = 0; v < SPAN; ++v, j += 32) {
    const bool in = j < cnt;
    f[v] = in ? (unsigned)__ldg(cf + j) : F_START;
    w[v] = in ? __ldg(cw + j) : T(0);
    r[v] = in ? __ldg(ci + j) : 0;
  }
}

// 32 rows of a group, row0 + lane in each lane (flags f, weight w,
// initiator r), with the carry (the same in every lane): results stored
// for the rows before the next group start; returns whether the group
// goes on past them.  The running weight before each row is one add a
// row, in order, in every lane; each lane turns its row into a map of the
// running initiator (rule_of), and the 32 maps are applied one after the
// other, two shuffles a row.
template <typename T>
__device__ __forceinline__ bool walk32(int row0, unsigned f, T w, int r,
                                       T& acc_w, int& acc_i,
                                       int* __restrict__ res,
                                       int* __restrict__ fill) {
  const int lane = threadIdx.x & 31;
  const unsigned starts = __ballot_sync(FULL, f & F_START);
  const int first = starts ? __ffs(starts) - 1 : 32;
  const bool go = lane < first;
  T before = acc_w, run = acc_w;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    const T ws = __shfl_sync(FULL, w, s);
    before = lane == s ? run : before;
    run = add_rn(run, s < first ? ws : T(0));
  }
  const unsigned R = rule_of(go, before, w, (f & F_GAP) != 0);
  int x = acc_i, out = 0;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    x = apply_rule(__shfl_sync(FULL, R, s), __shfl_sync(FULL, r, s), x);
    out = lane == s ? x : out;
  }
  acc_i = x;
  if (go) {
    res[row0 + lane] = out;
    fill[row0 + lane] = zero_run(add_rn(before, w), out);
  }
  acc_w = run;
  return first == 32;
}

// The whole warp finishes one group from compacted row p with carry
// (acc_w, acc_i) (the same values in every lane), 32 x SPAN rows a step,
// the next step's rows loaded (coalesced) while this step's are walked.
template <typename T>
__device__ void warp_walk(int p, T acc_w, int acc_i, int cnt,
                          const T* __restrict__ cw, const int* __restrict__ ci,
                          const unsigned char* __restrict__ cf,
                          int* __restrict__ res, int* __restrict__ fill) {
  const int lane = threadIdx.x & 31;
  T nw[SPAN];
  int ni[SPAN];
  unsigned nf[SPAN];
  stage(p + lane, cnt, cw, ci, cf, nw, ni, nf);
  for (;; p += 32 * SPAN) {
    T w[SPAN];
    int r[SPAN];
    unsigned f[SPAN];
#pragma unroll
    for (int v = 0; v < SPAN; ++v) {
      w[v] = nw[v];
      r[v] = ni[v];
      f[v] = nf[v];
    }
    stage(p + 32 * SPAN + lane, cnt, cw, ci, cf, nw, ni, nf);  // in flight
#pragma unroll
    for (int v = 0; v < SPAN; ++v)
      if (!walk32(p + 32 * v, f[v], w[v], r[v], acc_w, acc_i, res, fill))
        return;                               // the whole warp
  }
}

// One warp an open group, over pass 1's list (its order is immaterial:
// the groups are independent).
template <typename T>
__global__ void __launch_bounds__(THREADS)
k_seq_init_walk(const int* __restrict__ count,
                const int* __restrict__ open_total,
                const int* __restrict__ open_slot,
                const int* __restrict__ open_i, const T* __restrict__ open_w,
                const T* __restrict__ cw, const int* __restrict__ ci,
                const unsigned char* __restrict__ cf, int* __restrict__ res,
                int* __restrict__ fill) {
  const int m = *open_total, cnt = *count;
  for (int e = blockIdx.x * WARPS + (threadIdx.x >> 5); e < m;
       e += gridDim.x * WARPS)
    warp_walk<T>(open_slot[e], open_w[e], open_i[e], cnt, cw, ci, cf, res,
                 fill);
}

// ---------------------------------------------------------------------------
// Pass 3: every row from its last active row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
k_seq_init_fill(const unsigned long long* __restrict__ thread_rows,
                long long n, const int* __restrict__ res,
                const int* __restrict__ fill, int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long base = t * ITEMS;
  if (base >= n) return;
  const unsigned long long word = __ldcs(thread_rows + t);
  const unsigned act = (unsigned)(word >> 32);
  int slot = (int)(word & 0xffffffffu) - 1;
  int o[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool a = act >> i & 1u;
    slot += a;
    o[i] = a ? __ldg(res + slot) : __ldg(fill + slot);
  }
  if (base + ITEMS <= n) {
    uint4* p = reinterpret_cast<uint4*>(out + base);
    __stcs(p, make_uint4(o[0], o[1], o[2], o[3]));
    __stcs(p + 1, make_uint4(o[4], o[5], o[6], o[7]));
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (base + i < n) out[base + i] = o[i];
  }
}

long long round16(long long b) { return (b + 15) & ~15LL; }

// Scratch layout: the tiles' status words, the ticket and the open-list
// count (zeroed before each call), the active count; the compacted
// weights and initiators, res and fill ([n] each); the threads' masks and
// slots; the open list (OPEN entries a tile); the compacted flags.
struct Scratch {
  unsigned long long* status;
  int* ticket;
  int* count;
  void* cw;
  int* ci;
  unsigned char* cf;
  int* res;
  int* fill;
  unsigned long long* thread_rows;
  int* open_total;
  int* open_slot;
  int* open_i;
  void* open_w;
  long long bytes;
};

Scratch layout(void* base, long long n, int f64) {
  const long long tiles = (n + TILE - 1) / TILE;
  char* s = static_cast<char*>(base);
  Scratch c;
  long long o = 0;
  c.status = reinterpret_cast<unsigned long long*>(s + o);
  o += 8 * tiles;
  c.ticket = reinterpret_cast<int*>(s + o);
  c.open_total = c.ticket + 1;
  c.count = c.ticket + 2;
  o = round16(o + 12);
  c.cw = s + o;
  o = round16(o + n * (f64 ? 8 : 4));
  c.ci = reinterpret_cast<int*>(s + o);
  o = round16(o + 4 * n);
  c.res = reinterpret_cast<int*>(s + o);
  o = round16(o + 4 * n);
  c.fill = reinterpret_cast<int*>(s + o);
  o = round16(o + 4 * n);
  c.thread_rows = reinterpret_cast<unsigned long long*>(s + o);
  o = round16(o + 8 * ((n + ITEMS - 1) / ITEMS));
  c.open_w = s + o;
  o = round16(o + tiles * OPEN * (f64 ? 8 : 4));
  c.open_slot = reinterpret_cast<int*>(s + o);
  o = round16(o + 4 * tiles * OPEN);
  c.open_i = reinterpret_cast<int*>(s + o);
  o = round16(o + 4 * tiles * OPEN);
  c.cf = reinterpret_cast<unsigned char*>(s + o);
  o = round16(o + n);
  c.bytes = o;
  return c;
}

template <typename T>
int launch(const void* neq, const void* wt, const void* ini, long long n,
           void* out, void* scratch, cudaStream_t st) {
  const Scratch c = layout(scratch, n, sizeof(T) == 8);
  const long long tiles = (n + TILE - 1) / TILE;
  cudaError_t e = cudaMemsetAsync(c.status, 0, 8 * tiles + 8, st);
  if (e != cudaSuccess) return (int)e;
  const unsigned char* f = static_cast<const unsigned char*>(neq);
  const T* w = static_cast<const T*>(wt);
  k_seq_init_compact<T><<<(unsigned)tiles, THREADS + 32, 0, st>>>(
      f, w, static_cast<const int*>(ini), n, c.status, c.ticket, c.count,
      static_cast<T*>(c.cw), c.ci, c.cf, c.res, c.fill, c.thread_rows,
      c.open_total, c.open_slot, c.open_i, static_cast<T*>(c.open_w));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long walkers = tiles * OPEN / WARPS;
  k_seq_init_walk<T><<<(unsigned)(walkers < WALK_BLOCKS ? walkers
                                                        : WALK_BLOCKS),
                       THREADS, 0, st>>>(c.count, c.open_total, c.open_slot,
                                         c.open_i,
                                         static_cast<const T*>(c.open_w),
                                         static_cast<const T*>(c.cw), c.ci,
                                         c.cf, c.res, c.fill);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k_seq_init_fill<<<(unsigned)tiles, THREADS, 0, st>>>(
      c.thread_rows, n, c.res, c.fill, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sqmc_seq_init_init() { return 0; }

// Scratch the wrapper allocates on the device for sqmc_seq_init.
extern "C" long long sqmc_seq_init_scratch_bytes(long long n, int f64) {
  return layout(nullptr, n, f64).bytes;
}

// neq: [n] bool (one byte a row; row 0 starts a group whatever neq[0]
// says, as in the plain version); wt: [n] float32 (f64 = 0) or float64
// (f64 = 1); ini: [n] int32; out: [n] int32, every row written; scratch:
// sqmc_seq_init_scratch_bytes(n, f64) bytes.  Every pointer 16-byte
// aligned; 1 <= n < 2^31.
extern "C" int sqmc_seq_init(long long n, int f64, const void* neq,
                             const void* wt, const void* ini, void* out,
                             void* scratch, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(neq) |
                          reinterpret_cast<uintptr_t>(wt) |
                          reinterpret_cast<uintptr_t>(ini) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(scratch);
  if (align & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(neq, wt, ini, n, out, scratch, st)
             : launch<float>(neq, wt, ini, n, out, scratch, st);
}

extern "C" const char* sqmc_seq_init_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
