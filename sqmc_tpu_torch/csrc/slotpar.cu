// Slot -> parent expand of the walk's spawn slots, for Hopper (sm_90a).
//
// Replaces the TPU-shaped expand of sqmc_tpu/algo/walk.py:1444-1467: a
// scatter-max of each walker's index at its first slot plus lax.cummax,
// chosen there by v5e A/Bs (a [CAP] scatter and scan beat a sort-based
// searchsorted on the TPU).  It computes, bit for bit,
//     b = clip(cummax(scatter_max(clip(off, 0, CAP - 1), arange(M))), 0, M - 1)
// with off[i] = cum[i - 1] (0 for i = 0) the first slot of walker i and
// cum the inclusive prefix of the child counts.  For a nondecreasing cum
// (a prefix of counts >= 0) that is, at slot s < CAP - 1,
//     b[s] = #{j < M - 1 : cum[j] <= s},
// an upper-bound search over cum[0 .. M - 2]; every walker whose first
// slot is at or past CAP - 1 lands on slot CAP - 1 through the clip, so
// b[CAP - 1] = M - 1 whatever the spawn total.
//
// What bounds it: bytes.  cum is read once (8 B a walker) and b written
// once (8 B a slot): at the walk's shape (M = 458,752, CAP = 262,144)
// 5.8 MB, 1.72 us at the H100's 3.35 TB/s.
//
// Design: a merge of two sorted lists, the walkers' cum[0 .. M - 2] and
// the slots 0 .. CAP - 2, where walker i goes before slot s when cum[i] <=
// s; b[s] is the number of walkers merged before slot s.  Walker i's place
// in the merge is key(i) = cum[i] + i, which rises strictly, so the split
// of the merge after its first d items (how many of them are walkers) is
// #{i : key(i) < d}, held between d - (CAP - 1) and d.  Each block takes
// the next TILE items of the merge (merge path: walkers and slots together,
// so a block's work does not depend on how the children are spread; a
// walker owning thousands of slots or 100,000 childless walkers in a row
// cost a block the same).  The block finds its first split with a search
// in which every thread probes one place of the range each round
// (__syncthreads_count of the probes below d gives the sub-range: 3
// rounds at the walk's shape where a binary search takes 19 dependent
// loads), stages its window of cum in shared memory with one coalesced
// read, and each thread finds its own split there, merges its ITEMS items
// in order and notes each slot's walker in shared memory; the block then
// writes its run of b with consecutive threads on consecutive slots.
// Tiles wholly past the last walker write M - 1 without a search.  The
// last slot is written apart (the clip).  Each slot has one writer.
//
// Measured (chip_smoke.py phase 2d, NVIDIA H100 80GB HBM3, 700 W): 6.0
// us at the walk's shape against 7.6 us for a binary search per slot and
// 7.2 us for torch.searchsorted; still 3.5x the bytes bound, a chain of
// dependent memory round trips (the block's search, its window, its
// writes).  Inside the HEG-14 walk, whose walkers are mostly childless,
// it is slower than the binary search (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ITEMS = 8;                      // merge items a thread
constexpr int TILE = THREADS * ITEMS;         // merge items a block

// The split of the merge after its first d items: #{i < n : cum[i] + i <
// d}, at least d - ns (ns slots in the merge).  Every thread of the block
// calls it with the same arguments; each round every thread probes one
// place of the remaining range, and the block keeps the part between
// the last probe below d and the first one not below it.  The last
// walker's key is read beside the first round's probes: when it is below
// d, every walker is merged before d (the split is n) and the search
// stops there.
__device__ long long block_split(const long long* __restrict__ cum,
                                 long long n, long long ns, long long d) {
  const int t = threadIdx.x;
  long long lo = d - ns > 0 ? d - ns : 0;
  long long hi = d < n ? d : n;
  const long long last = __ldg(cum + n - 1) + n - 1;
  bool first = true;
  while (hi > lo) {
    const long long span = hi - lo;
    const bool all = span <= THREADS;         // probe every place
    const long long q = all ? lo + t : lo + (t + 1) * span / (THREADS + 1);
    const bool probe = !all || t < span;
    const bool below = probe && __ldg(cum + q) + q < d;
    if (first) {
      first = false;
      if (last < d) return n;
    }
    const int c = __syncthreads_count(below);
    if (all) return lo + c;
    const long long nlo = c > 0 ? lo + (long long)c * span / (THREADS + 1) + 1
                                : lo;
    hi = c < THREADS ? lo + (long long)(c + 1) * span / (THREADS + 1) : hi;
    lo = nlo;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
k_slot_parents(const long long* __restrict__ cum, long long m, long long cap,
               long long* __restrict__ b) {
  __shared__ int cw[TILE];                    // cum[i0 + k] - j0, clipped
  __shared__ int walker[TILE];                // a slot's walker - i0
  __shared__ long long s_end;                 // the slot after the tile's
  const int t = threadIdx.x;
  const long long n = m - 1, ns = cap - 1, total = n + ns;
  const long long d0 = (long long)blockIdx.x * TILE;
  const long long d1 = d0 + TILE < total ? d0 + TILE : total;
  if (blockIdx.x == 0 && t == 0) b[ns] = n;   // the clip: b[CAP - 1] = M - 1
  if (d0 >= total) return;

  // i0 == n: every walker merged before the tile, whose slots all have
  // parent M - 1
  const long long i0 = n == 0 ? 0 : block_split(cum, n, ns, d0);
  if (i0 == n) {
    for (long long j = d0 - n + t; j < d1 - n; j += THREADS) b[j] = n;
    return;
  }
  // The window in tile coordinates: walker i0 + k's first slot past the
  // tile's first slot j0 (>= 0: slot j0 - 1 merges before walker i0),
  // clipped to TILE, past which no slot of the tile can be.
  const long long j0 = d0 - i0;
  const int wn = (int)(n - i0 < TILE ? n - i0 : TILE);
  for (int k = t; k < wn; k += THREADS) {
    const long long c = __ldg(cum + i0 + k) - j0;
    cw[k] = (int)(c < TILE ? c : TILE);
  }
  __syncthreads();

  const int e = t * ITEMS;                    // this thread's first item
  const int items = (int)(d1 - d0);
  // slots of the tile before ns, the slots' end (TILE: none in the tile)
  const int send = ns - j0 < TILE ? (int)(ns - j0) : TILE;
  if (e < items) {
    // this thread's split, searched in the window: walkers k with
    // cw[k] + k < e, at least e - send
    int lo = e - send > 0 ? e - send : 0;
    int hi = e < wn ? e : wn;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cw[mid] + mid < e) lo = mid + 1; else hi = mid;
    }
    int k = lo, s = e - lo;                   // walker i0 + k, slot j0 + s
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (e + u >= items) break;
      if (k < wn && (s >= send || cw[k] <= s)) {
        ++k;                                  // walker i0 + k merged
      } else {
        walker[s] = k;                        // slot j0 + s: walkers before
        ++s;
      }
    }
    if (e + ITEMS >= items) s_end = j0 + s;
  }
  __syncthreads();
  const long long nslots = s_end - j0;
  for (long long k = t; k < nslots; k += THREADS) b[j0 + k] = i0 + walker[k];
}

long long grid_of(long long m, long long cap) {
  const long long total = (m - 1) + (cap - 1);
  const long long blocks = (total + TILE - 1) / TILE;
  return blocks > 0 ? blocks : 1;
}

}  // namespace

extern "C" int sqmc_slot_parents_init() { return 0; }

// The launch for m walkers and cap slots: out[0] blocks, out[1] threads a
// block, out[2] static shared bytes a block, out[3] resident blocks per
// SM, out[4] merge items a block.
extern "C" int sqmc_slot_parents_shape(long long m, long long cap,
                                       long long* out) {
  if (m <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, k_slot_parents);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_slot_parents,
                                                    THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = grid_of(m, cap);
  out[1] = THREADS;
  out[2] = (long long)attr.sharedSizeBytes;
  out[3] = per_sm;
  out[4] = TILE;
  return 0;
}

// cum: [m] int64, nondecreasing and >= 0; b: [cap] int64, every entry
// written.
extern "C" int sqmc_slot_parents(long long m, long long cap, const void* cum,
                                 void* b, void* stream) {
  if (m <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = grid_of(m, cap);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k_slot_parents<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cum), m, cap, static_cast<long long*>(b));
  return (int)cudaGetLastError();
}

extern "C" const char* sqmc_slot_parents_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
