// Fused multi-field inclusive segmented scan for Hopper (sm_90a), in one
// pass with decoupled look-back.
//
// Replaces the Pallas TPU kernel sqmc_tpu/ops/pscan.py:163 `_seg_scan_call`
// (kernel body `_make_kernel`), which the walk's annihilation merge
// reaches through segscan.seg_scan (sqmc_tpu/algo/walk.py:2243-2250).
//
// Semantics: fields[k][i] becomes the reduction (sum, min or max) of
// fields[k] over rows seg_start(i)..i, where start[i] != 0 marks a segment
// start.  The combine is the segmented monoid
//     (f1, v1) (+) (f2, v2) = (f1 | f2,  f2 ? v2 : op(v1, v2)).
// Up to 8 fields of int32, uint32 (native unsigned min/max), float32 or
// float64 ride one call, each with its own op; the flags are read once for
// all fields.
//
// What bounds it: bytes.  One read of the 1-byte flags and of every field
// and one write of every field: at the walk's merge shape (N = 720,896
// rows, three 4-byte integer and three float32 fields) 49 B a row,
// 35.3 MB, 10.5 us at the H100's 3.35 TB/s (float64 state: 73 B a row,
// 52.6 MB, 15.7 us).  The TPU kernel carried the scan across sequential
// grid steps in VMEM; blocks on Hopper run in no order, so this kernel is
// the single-pass scan of Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back" (NVIDIA, 2016):
//   1. each block takes its 2048-row tile from an atomic ticket, so every
//      tile it looks back at has already started (forward progress);
//   2. it copies the tile's fields into shared memory with 16-byte
//      cp.async copies, all in flight together, and each thread reads its 8
//      flag bytes as one 8-byte load: every byte is read from device memory
//      once;
//   3. each thread scans its 8 consecutive rows in registers and writes the
//      local scan back to shared memory; a warp scan of the thread totals
//      gives each warp's total, and warp 0 folds them into the tile's
//      aggregate and each warp's prefix within the tile (the segment flags'
//      share of every scan is computed once, for all fields);
//   4. warp 0 publishes the aggregate (lane 0 writes the flag and nf
//      values, then the status word with release ordering), looks back
//      over 32 predecessors at a time (status read with acquire ordering)
//      until the nearest one that has published its inclusive prefix or
//      whose aggregate holds a segment start -- nothing before a start can
//      reach this tile -- and publishes its own inclusive prefix;
//   5. every thread combines its carry-in (tile carry, warp prefix, lane
//      prefix) with the local scans of its rows that precede their
//      thread's first segment start, and the block writes the tile back
//      with 16-byte stores.
// The status words and the ticket are zeroed by a cudaMemsetAsync in the
// C entry point before each launch (stream-ordered; scratch comes from the
// wrapper).  The ragged last tile is masked (rows past N act as identities
// with no flag).  The wrapper (ops/segscan.py) copies a view that is not
// 16-byte aligned.
//
// Measured (chip_smoke.py phase 2c, H100): ~26 us of kernel time at the
// walk shape, 2.5x the bound, and ~11-12 us for a one-tile call: each tile
// is a chain of dependent steps (ticket, copies, two passes over the fields
// with shuffles, release/acquire, stores), and the walk's 352 tiles run in
// one wave, so that chain adds to the copy time instead of hiding behind
// other tiles' copies.  Other tile shapes (512-4,096 rows, 128-512
// threads) did no better at the walk shape.
//
// Determinism: no atomics touch the values.  When every tile holds a
// segment start, each look-back stops at its nearest predecessor, whose
// aggregate and inclusive prefix then carry the same value, so the result
// is the same bits on every run.  Only a segment that covers a whole tile
// (2,048+ rows with no start) makes the carry depend on how far the
// look-back had to go, and a float sum there may differ in its last ulps
// between runs.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MAX_FIELDS 8
#define TILE 2048                      // rows per tile
#define THREADS 256
#define ITEMS (TILE / THREADS)         // 8 consecutive rows per thread
#define WARPS (THREADS / 32)
#define FULL 0xffffffffu

enum { DT_I32 = 0, DT_U32 = 1, DT_F32 = 2, DT_F64 = 3 };
enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };
enum { ST_NONE = 0, ST_AGG = 1, ST_INC = 2 };      // tile status words

struct Desc {
  const void* in[MAX_FIELDS];
  void* out[MAX_FIELDS];
  int dtype[MAX_FIELDS];
  int op[MAX_FIELDS];
  int size[MAX_FIELDS];            // bytes per row
  int off[MAX_FIELDS];             // staging offset in dynamic shared memory
  int nf;
};

// Identities: op(identity, x) == x exactly (a float sum starts at -0.0,
// which leaves every x, signed zeros included, unchanged).
template <typename T> struct Lim;
template <> struct Lim<int> {
  static __device__ __forceinline__ int zero() { return 0; }
  static __device__ __forceinline__ int lo() { return (int)0x80000000; }
  static __device__ __forceinline__ int hi() { return 0x7fffffff; }
};
template <> struct Lim<unsigned> {
  static __device__ __forceinline__ unsigned zero() { return 0u; }
  static __device__ __forceinline__ unsigned lo() { return 0u; }
  static __device__ __forceinline__ unsigned hi() { return 0xffffffffu; }
};
template <> struct Lim<float> {
  static __device__ __forceinline__ float zero() { return __int_as_float(0x80000000); }
  static __device__ __forceinline__ float lo() { return __int_as_float(0xff800000); }
  static __device__ __forceinline__ float hi() { return __int_as_float(0x7f800000); }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double zero() { return __longlong_as_double(0x8000000000000000ULL); }
  static __device__ __forceinline__ double lo() { return __longlong_as_double(0xfff0000000000000ULL); }
  static __device__ __forceinline__ double hi() { return __longlong_as_double(0x7ff0000000000000ULL); }
};

template <typename T, int OP>
__device__ __forceinline__ T identity() {
  return OP == OP_SUM ? Lim<T>::zero() : (OP == OP_MIN ? Lim<T>::hi() : Lim<T>::lo());
}

template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_MIN) return b < a ? b : a;
  return b > a ? b : a;
}

// (f, v) <- (fa, va) (+) (f, v)
template <typename T, int OP>
__device__ __forceinline__ void combine_left(int fa, T va, int& f, T& v) {
  v = f ? v : apply<T, OP>(va, v);
  f = f | fa;
}

// Values of any field type travel through 8-byte slots (low bytes).
template <typename T>
__device__ __forceinline__ T from_raw(unsigned long long r) {
  T v;
  memcpy(&v, &r, sizeof(T));
  return v;
}
template <typename T>
__device__ __forceinline__ unsigned long long to_raw(T v) {
  unsigned long long r = 0;
  memcpy(&r, &v, sizeof(T));
  return r;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// ---------------------------------------------------------------------------
// Shared-memory staging: 16-byte copies in and out
// ---------------------------------------------------------------------------

// Copy `bytes` bytes from global g to shared s with 16-byte cp.async copies
// (a short last chunk is zero-filled); both ends 16-byte aligned.
__device__ __forceinline__ void stage_in(char* s, const char* g, int bytes) {
  for (int o = threadIdx.x * 16; o < bytes; o += THREADS * 16) {
    const int b = bytes - o < 16 ? bytes - o : 16;
    const unsigned sa = (unsigned)__cvta_generic_to_shared(s + o);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(sa), "l"(g + o), "r"(b) : "memory");
  }
}

// Copy `bytes` bytes (a multiple of 4) from shared s to global g: 16-byte
// stores, 4-byte words for a short last chunk.
__device__ __forceinline__ void stage_out(char* g, const char* s, int bytes) {
  for (int o = threadIdx.x * 16; o < bytes; o += THREADS * 16) {
    if (bytes - o >= 16) {
      *reinterpret_cast<uint4*>(g + o) = *reinterpret_cast<const uint4*>(s + o);
    } else {
      for (int w = o; w < bytes; w += 4)
        *reinterpret_cast<unsigned*>(g + w) = *reinterpret_cast<const unsigned*>(s + w);
    }
  }
}

// This thread's ITEMS consecutive rows of a staged field.
template <typename T>
__device__ __forceinline__ void read_items(const char* sm, T* x) {
  const uint4* p = reinterpret_cast<const uint4*>(sm + threadIdx.x * ITEMS * sizeof(T));
  uint4 raw[ITEMS * sizeof(T) / 16];
#pragma unroll
  for (int j = 0; j < ITEMS * (int)sizeof(T) / 16; ++j) raw[j] = p[j];
  memcpy(x, raw, sizeof(raw));
}

template <typename T>
__device__ __forceinline__ void write_items(char* sm, const T* x) {
  uint4 raw[ITEMS * sizeof(T) / 16];
  memcpy(raw, x, sizeof(raw));
  uint4* p = reinterpret_cast<uint4*>(sm + threadIdx.x * ITEMS * sizeof(T));
#pragma unroll
  for (int j = 0; j < ITEMS * (int)sizeof(T) / 16; ++j) p[j] = raw[j];
}

#define DISPATCH(dt, op, FN, ...)                                   \
  switch ((dt) * 3 + (op)) {                                        \
    case 0: FN<int, OP_SUM>(__VA_ARGS__); break;                    \
    case 1: FN<int, OP_MIN>(__VA_ARGS__); break;                    \
    case 2: FN<int, OP_MAX>(__VA_ARGS__); break;                    \
    case 3: FN<unsigned, OP_SUM>(__VA_ARGS__); break;               \
    case 4: FN<unsigned, OP_MIN>(__VA_ARGS__); break;               \
    case 5: FN<unsigned, OP_MAX>(__VA_ARGS__); break;               \
    case 6: FN<float, OP_SUM>(__VA_ARGS__); break;                  \
    case 7: FN<float, OP_MIN>(__VA_ARGS__); break;                  \
    case 8: FN<float, OP_MAX>(__VA_ARGS__); break;                  \
    case 9: FN<double, OP_SUM>(__VA_ARGS__); break;                 \
    case 10: FN<double, OP_MIN>(__VA_ARGS__); break;                \
    case 11: FN<double, OP_MAX>(__VA_ARGS__); break;                \
    default: break;                                                 \
  }

// Block-shared state of one tile
struct Tile {
  int wf[WARPS];                              // warp totals' flags
  int wxf[WARPS];                             // flags before each warp
  unsigned long long wv[MAX_FIELDS][WARPS];   // warp totals per field
  unsigned long long wx[MAX_FIELDS][WARPS];   // prefix before each warp
  unsigned long long agg[MAX_FIELDS];         // tile aggregate per field
  unsigned long long excl[MAX_FIELDS];        // carry-in per field
  unsigned long long inc[MAX_FIELDS];         // inclusive prefix per field
  int tflag, eflag, tile;
};

// The segment flags' share of every field's scan, computed once per thread.
struct Flags {
  unsigned seen;   // bit i: a start among this thread's rows 0..i
  unsigned take;   // bit l: the warp scan combines at distance 1 << l
  int lane_f;      // a start in this warp's earlier lanes
  int warp_f;      // a start in this warp's lanes up to this one
};

__device__ __forceinline__ Flags flag_structure(const int* fl, int lane) {
  Flags F;
  int run = 0;
  F.seen = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    run |= fl[i];
    F.seen |= (unsigned)run << i;
  }
  int f = run;
  F.take = 0;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int fu = __shfl_up_sync(FULL, f, 1 << l);
    if (lane >= (1 << l)) {
      if (!f) F.take |= 1u << l;
      f |= fu;
    }
  }
  F.warp_f = f;
  F.lane_f = __shfl_up_sync(FULL, f, 1);
  if (lane == 0) F.lane_f = 0;
  return F;
}

// Inclusive scan of the thread totals v across the warp (flags from F).
template <typename T, int OP>
__device__ __forceinline__ T warp_scan_values(const Flags& F, T v) {
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const T vu = __shfl_up_sync(FULL, v, 1 << l);
    if (F.take >> l & 1u) v = apply<T, OP>(vu, v);
  }
  return v;
}

// Global look-back state (scratch from the wrapper)
struct Board {
  int* status;                     // [n_tiles] ST_*, zeroed per call
  int* agg_f;                      // [n_tiles]
  int* inc_f;                      // [n_tiles]
  unsigned long long* agg_v;       // [nf][n_tiles]
  unsigned long long* inc_v;       // [nf][n_tiles]
  int n_tiles;
};

// ---------------------------------------------------------------------------
// Step 3: local scans and warp totals per field
// ---------------------------------------------------------------------------

template <typename T, int OP>
__device__ void local_scan(char* sm, const int* fl, const Flags& F,
                           long long base, long long n, int k, Tile& S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x[ITEMS];
  read_items<T>(sm, x);
  T r = identity<T, OP>();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const T xi = base + i < n ? x[i] : identity<T, OP>();
    r = fl[i] ? xi : apply<T, OP>(r, xi);
    x[i] = r;
  }
  write_items<T>(sm, x);
  const T v = warp_scan_values<T, OP>(F, r);
  if (lane == 31) S.wv[k][warp] = to_raw(v);
}

// ---------------------------------------------------------------------------
// Step 4: publish, look back, publish (warp 0; lane k < nf owns field k)
// ---------------------------------------------------------------------------

// Tile aggregate of field k and the prefix before each warp: lane w < 8
// of warp 0 holds warp w's total, and three shuffle steps scan them.
template <typename T, int OP>
__device__ void tile_aggregate(int k, int lane, Tile& S) {
  int f = lane < WARPS ? S.wf[lane] : 0;
  T v = lane < WARPS ? from_raw<T>(S.wv[k][lane]) : identity<T, OP>();
#pragma unroll
  for (int d = 1; d < WARPS; d <<= 1) {
    const int fu = __shfl_up_sync(FULL, f, d);
    const T vu = __shfl_up_sync(FULL, v, d);
    if (lane >= d) combine_left<T, OP>(fu, vu, f, v);
  }
  int ef = __shfl_up_sync(FULL, f, 1);
  T ev = __shfl_up_sync(FULL, v, 1);
  if (lane == 0) {
    ef = 0;
    ev = identity<T, OP>();
    S.excl[k] = to_raw(ev);
  }
  if (lane < WARPS) {
    S.wx[k][lane] = to_raw(ev);
    if (k == 0) S.wxf[lane] = ef;
  }
  if (lane == WARPS - 1) {
    S.agg[k] = to_raw(v);
    if (k == 0) S.tflag = f;
  }
}

// inclusive prefix of field k = carry-in (+) aggregate
template <typename T, int OP>
__device__ void inclusive(int k, Tile& S) {
  int f = S.tflag;
  T v = from_raw<T>(S.agg[k]);
  combine_left<T, OP>(S.eflag, from_raw<T>(S.excl[k]), f, v);
  S.inc[k] = to_raw(v);
}

// Lane 0 writes a flag and nf values, then the status word with release
// ordering, which makes its earlier writes visible to an acquiring reader.
__device__ __forceinline__ void publish(const Board& B, int tile, int nf,
                                        int* flags, unsigned long long* vals,
                                        int f, const unsigned long long* v,
                                        int status) {
  flags[tile] = f;
  for (int k = 0; k < nf; ++k) vals[(size_t)k * B.n_tiles + tile] = v[k];
  st_release(B.status + tile, status);
}

// Fold field k over this look-back window: lane i holds predecessor
// tile - 1 - i (lanes past the stop hold identities); lane 0 ends with the
// window's fold, farthest tile leftmost, and folds it into the carry-in.
template <typename T, int OP>
__device__ void window_fold(int k, int lane, bool use, bool inc, int t,
                            int f, const Board& B, Tile& S) {
  T v = identity<T, OP>();
  if (use)
    v = from_raw<T>(__ldcg((inc ? B.inc_v : B.agg_v) + (size_t)k * B.n_tiles + t));
  int fl = use ? f : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int fo = __shfl_down_sync(FULL, fl, d);
    T vo = __shfl_down_sync(FULL, v, d);
    if (lane + d < 32) combine_left<T, OP>(fo, vo, fl, v);
  }
  if (lane == 0) {
    int ef = S.eflag;
    T ev = from_raw<T>(S.excl[k]);
    combine_left<T, OP>(fl, v, ef, ev);
    S.excl[k] = to_raw(ev);
  }
}

__device__ void publish_and_look_back(const Desc& d, const Board& B, Tile& S) {
  const int lane = threadIdx.x;
  const int tile = S.tile;
  for (int k = 0; k < d.nf; ++k)
    DISPATCH(d.dtype[k], d.op[k], tile_aggregate, k, lane, S);
  if (lane == 0) S.eflag = 0;
  __syncwarp();
  if (tile > 0) {
    // the aggregate, for successors that reach this tile before its prefix
    if (lane == 0)
      publish(B, tile, d.nf, B.agg_f, B.agg_v, S.tflag, S.agg, ST_AGG);
    for (int pred = tile - 1;; pred -= 32) {
      const int t = pred - lane;
      int st = ST_INC, f = 0;
      if (t >= 0) {
        while ((st = ld_acquire(B.status + t)) == ST_NONE) {
        }
        f = __ldcg((st == ST_INC ? B.inc_f : B.agg_f) + t);
      }
      // stop at the nearest tile with a prefix or a segment start
      const unsigned stop = __ballot_sync(FULL, st == ST_INC || f != 0);
      const int last = stop ? __ffs(stop) - 1 : 31;
      const bool use = lane <= last && t >= 0;
      const int wflag = __any_sync(FULL, use && f != 0);
      for (int k = 0; k < d.nf; ++k) {
        DISPATCH(d.dtype[k], d.op[k], window_fold, k, lane, use, st == ST_INC,
                 t, f, B, S);
      }
      __syncwarp();
      if (lane == 0) S.eflag |= wflag;
      __syncwarp();
      if (stop) break;
    }
  }
  // the inclusive prefix
  if (lane < d.nf) DISPATCH(d.dtype[lane], d.op[lane], inclusive, lane, S);
  __syncwarp();
  if (lane == 0)
    publish(B, tile, d.nf, B.inc_f, B.inc_v, S.eflag | S.tflag, S.inc, ST_INC);
}

// ---------------------------------------------------------------------------
// Step 5: the carry-in into every row before its thread's first start
// ---------------------------------------------------------------------------

template <typename T, int OP>
__device__ void finish(char* sm, const Flags& F, int k, const Tile& S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x[ITEMS];
  read_items<T>(sm, x);
  // the lanes before this one, from the thread totals (x[ITEMS - 1])
  T lv = __shfl_up_sync(FULL, warp_scan_values<T, OP>(F, x[ITEMS - 1]), 1);
  if (lane == 0) lv = identity<T, OP>();
  // carry-in = tile carry (+) earlier warps (+) earlier lanes
  int wf = S.wxf[warp];
  T wv = from_raw<T>(S.wx[k][warp]);
  combine_left<T, OP>(S.eflag, from_raw<T>(S.excl[k]), wf, wv);
  int lf = F.lane_f;
  combine_left<T, OP>(wf, wv, lf, lv);
  // rows before the thread's first start take the carry-in
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (!(F.seen >> i & 1u)) x[i] = apply<T, OP>(lv, x[i]);
  write_items<T>(sm, x);
}

// ---------------------------------------------------------------------------
// The kernel: one block per tile, tiles in ticket order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
k_seg_scan(long long n, const uint8_t* __restrict__ start, Desc d, Board B,
           int* ticket) {
  extern __shared__ __align__(16) char smem[];   // each field's rows
  __shared__ Tile S;
  if (threadIdx.x == 0) S.tile = atomicAdd(ticket, 1);
  __syncthreads();
  const long long tbase = (long long)S.tile * TILE;
  const int rows = n - tbase < TILE ? (int)(n - tbase) : TILE;

  for (int k = 0; k < d.nf; ++k)
    stage_in(smem + d.off[k],
             static_cast<const char*>(d.in[k]) + tbase * d.size[k],
             rows * d.size[k]);
  asm volatile("cp.async.commit_group;" ::: "memory");
  // this thread's 8 flags, while the fields are in flight
  const long long base = tbase + (long long)threadIdx.x * ITEMS;
  int fl[ITEMS];
  if (base + ITEMS <= n) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(start + base));
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      fl[i] = (((i < 4 ? w.x : w.y) >> (8 * (i & 3))) & 0xffu) != 0;
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) fl[i] = base + i < n ? start[base + i] != 0 : 0;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  const Flags F = flag_structure(fl, threadIdx.x & 31);
  if ((threadIdx.x & 31) == 31) S.wf[threadIdx.x >> 5] = F.warp_f;
  for (int k = 0; k < d.nf; ++k)
    DISPATCH(d.dtype[k], d.op[k], local_scan, smem + d.off[k], fl, F, base,
             n, k, S);
  __syncthreads();
  if (threadIdx.x < 32) publish_and_look_back(d, B, S);
  __syncthreads();
  for (int k = 0; k < d.nf; ++k)
    DISPATCH(d.dtype[k], d.op[k], finish, smem + d.off[k], F, k, S);
  __syncthreads();
  for (int k = 0; k < d.nf; ++k)
    stage_out(static_cast<char*>(d.out[k]) + tbase * d.size[k],
              smem + d.off[k], rows * d.size[k]);
}

// ---------------------------------------------------------------------------
// Plain C entry point (bound with ctypes)
// ---------------------------------------------------------------------------

static long long round8(long long b) { return (b + 7) & ~7LL; }

// Launch attributes: room for the largest staging (8 float64 fields) and
// the largest shared-memory carveout.  Called once per device, with that
// device current, before the first launch there.
extern "C" int sqmc_seg_scan_init() {
  cudaError_t e = cudaFuncSetAttribute(
      k_seg_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_FIELDS * TILE * 8);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(k_seg_scan,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// Scratch the wrapper allocates on the device for sqmc_seg_scan.
extern "C" long long sqmc_seg_scan_scratch_bytes(long long n, int nf) {
  const long long t = (n + TILE - 1) / TILE;
  return round8(4 * (t + 1)) + 2 * round8(4 * t) + 2 * 8 * t * nf;
}

// start: [n] bool; in_ptrs / out_ptrs: nf device pointers, all 16-byte
// aligned; scratch: sqmc_seg_scan_scratch_bytes(n, nf) bytes on the device.
extern "C" int sqmc_seg_scan(long long n, int nf, const void* start,
                             void** in_ptrs, void** out_ptrs,
                             const int* dtypes, const int* ops,
                             void* scratch, void* stream) {
  if (n <= 0 || nf < 1 || nf > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  Desc d;
  d.nf = nf;
  int smem = 0;
  uintptr_t align = reinterpret_cast<uintptr_t>(start);
  for (int k = 0; k < MAX_FIELDS; ++k) {
    const bool on = k < nf;
    d.in[k] = on ? in_ptrs[k] : nullptr;
    d.out[k] = on ? out_ptrs[k] : nullptr;
    d.dtype[k] = on ? dtypes[k] : 0;
    d.op[k] = on ? ops[k] : 0;
    if (on && (d.dtype[k] < 0 || d.dtype[k] > DT_F64 || d.op[k] < 0 ||
               d.op[k] > OP_MAX))
      return (int)cudaErrorInvalidValue;
    d.size[k] = d.dtype[k] == DT_F64 ? 8 : 4;
    d.off[k] = smem;
    if (on) {
      smem += TILE * d.size[k];
      align |= reinterpret_cast<uintptr_t>(d.in[k]) |
               reinterpret_cast<uintptr_t>(d.out[k]);
    }
  }
  if (align & 15) return (int)cudaErrorMisalignedAddress;
  const long long tiles = (n + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Board B;
  B.n_tiles = (int)tiles;
  char* s = static_cast<char*>(scratch);
  B.status = reinterpret_cast<int*>(s);
  int* ticket = B.status + tiles;
  s += round8(4 * (tiles + 1));
  B.agg_f = reinterpret_cast<int*>(s);
  s += round8(4 * tiles);
  B.inc_f = reinterpret_cast<int*>(s);
  s += round8(4 * tiles);
  B.agg_v = reinterpret_cast<unsigned long long*>(s);
  B.inc_v = B.agg_v + tiles * nf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const cudaError_t e = cudaMemsetAsync(B.status, 0, 4 * (tiles + 1), st);
  if (e != cudaSuccess) return (int)e;
  k_seg_scan<<<B.n_tiles, THREADS, smem, st>>>(
      n, static_cast<const uint8_t*>(start), d, B, ticket);
  return (int)cudaGetLastError();
}

extern "C" const char* sqmc_seg_scan_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
