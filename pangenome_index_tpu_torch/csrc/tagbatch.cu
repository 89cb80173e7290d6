// K6: batched tag-array interval queries with position lists; a block of 128
// threads answers 128 consecutive intervals.
//
// Replaces ops/tagquery.py:query_tags_batch, an XLA program on the TPU that
// gathered a full [B, capacity] window of pos_enc, sorted it, and
// compacted the first occurrences with a second sort (argsort) - two sorts
// of `capacity` slots per query. Semantics kept exactly: two upper-bound
// searches over the sorted tag run heads give first_bit and end_bit,
// run_nums = end_bit - first_bit + 1; the window starts at the reference's
// mod-10 quirk (first_bit if first_bit % START_EVERY_K == 0, else
// first_bit - 1), or at max(first_bit - 1, 0) when exact; window slot i
// holds pos_enc[s + i] when i < run_nums and 0 <= s + i < t. Output: the
// distinct values ascending at the front of the row, then -1; n_runs =
// run_nums (also when <= 0 or > capacity); overflow = run_nums > capacity.
//
// What bounds it: the bytes of the output. A row is `capacity` int64 slots
// (2 KB at the command line's 256) of which about one holds a value on
// pangenome workloads, so the kernel is a fill of -1 with a few values in
// it. The design separates finding a row's values from writing the rows:
//
// 1. Finding, one thread an interval: the two searches through the tag
//    search tree, which the four lanes of a quad make together for their
//    four intervals (tags.cuh), the window bounds, then by the number v of
//    valid window slots
//    - v <= 8: the thread loads them into registers, sorts them with a
//      network, drops repeats and leaves the distinct values in the block's
//      shared memory;
//    - 8 < v <= 32: the thread's warp takes the row: a lane a value, a
//      bitonic sort by shuffles, neighbours compared, a ballot for the
//      compaction, and one coalesced store of the distinct values;
//    - v > 32: the block takes the row: a bitonic sort over the next power
//      of two in dynamic shared memory (kBig as the pad), neighbours
//      compared, ballots and a prefix over the warps for the compaction.
//    No row is sorted in device memory, whatever its width.
// 2. Writing: the 128 rows of a block are one contiguous span of the output.
//    The block walks it with every thread storing 16 bytes next to its
//    neighbour's (streaming stores: the output is written once and is far
//    larger than L2): a row's values from shared memory, then -1. Slots
//    that a warp or the block already wrote in step 1 are left alone.
//
// The run heads and intervals are int32 below 2^31 BWT rows and int64 past
// it (a tree line of 8 keys); the key type is a template parameter.
#include <cstdint>
#include <cuda_runtime.h>

#include "tags.cuh"

namespace {

using pgt::kBig;
using pgt::kStartEveryK;
using pgt::load64;

constexpr int kThreads = 128;   // threads, and intervals, of a block
constexpr int kWarps = kThreads / 32;
constexpr int kTiny = 8;        // widest row a thread sorts in its registers
constexpr int kWarpRow = 32;    // widest row a warp sorts by shuffles
constexpr unsigned kFull = 0xffffffffu;
// widest row: the block's sort buffer is the next power of two, in shared memory
constexpr int kMaxCapacity = 1 << 14;

__device__ __forceinline__ void order(int64_t& a, int64_t& b) {
  const int64_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// ascending sort of 8 registers (19 compare-exchanges)
__device__ __forceinline__ void sort8(int64_t (&x)[kTiny]) {
  order(x[0], x[1]); order(x[2], x[3]); order(x[4], x[5]); order(x[6], x[7]);
  order(x[0], x[2]); order(x[1], x[3]); order(x[4], x[6]); order(x[5], x[7]);
  order(x[1], x[2]); order(x[5], x[6]); order(x[0], x[4]); order(x[3], x[7]);
  order(x[1], x[5]); order(x[2], x[6]);
  order(x[1], x[4]); order(x[3], x[6]);
  order(x[2], x[4]); order(x[3], x[5]);
  order(x[3], x[4]);
}

template <class K>
__global__ void query_tags_batch_kernel(
    pgt::SearchTree<K> tree, int64_t n_runs, const int64_t* __restrict__ pos_enc,
    const K* __restrict__ start, const K* __restrict__ end, int64_t n,
    int capacity, int exact, int64_t* __restrict__ positions,
    int* __restrict__ n_unique, int* __restrict__ n_runs_out,
    uint8_t* __restrict__ overflow) {
  extern __shared__ int64_t big_row[];           // the block's sort buffer
  __shared__ int64_t tiny[kTiny][kThreads];      // distinct values of thread-sorted rows
  __shared__ int win_start[kThreads];            // first valid window slot in pos_enc
  __shared__ int win_n[kThreads];                // valid window slots (v)
  // distinct values u of the row: u when a thread sorted it (they are in
  // `tiny`), -1 - u when a warp or the block did (they are in place)
  __shared__ int row_info[kThreads];
  __shared__ int wide_rows[kThreads], n_wide;    // rows left to the block
  __shared__ int warp_kept[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t b = b0 + tid;
  if (tid == 0) n_wide = 0;
  __syncthreads();

  // --- 1. finding --------------------------------------------------------
  int v = 0, w0 = 0;
  const K ends[2] = {b < n ? pgt::load_key(start + b) : 0,
                     b < n ? pgt::load_key(end + b) : 0};
  int bits[2];
  pgt::upper_bound_ends(tree, ends, b < n, bits);  // by quads: every lane goes in
  if (b < n) {
    const int64_t first_bit = bits[0];
    const int64_t run_nums = static_cast<int64_t>(bits[1]) - first_bit + 1;
    int64_t s;
    if (exact) {
      s = first_bit > 0 ? first_bit - 1 : 0;
    } else {
      s = (first_bit % kStartEveryK == 0) ? first_bit : first_bit - 1;
    }
    // valid window slots: max(0, -s) <= i < min(run_nums, capacity, t - s)
    const int64_t lo = s < 0 ? -s : 0;
    int64_t hi = run_nums < capacity ? run_nums : capacity;
    hi = hi < n_runs - s ? hi : n_runs - s;
    v = hi > lo ? static_cast<int>(hi - lo) : 0;
    w0 = static_cast<int>(s + lo);
    n_runs_out[b] = static_cast<int>(run_nums);
    overflow[b] = run_nums > capacity ? 1 : 0;
  }
  win_start[tid] = w0;
  win_n[tid] = v;
  int u = 0;
  if (v <= kTiny) {
    int64_t x[kTiny];
#pragma unroll
    for (int i = 0; i < kTiny; ++i) x[i] = i < v ? load64(pos_enc + w0 + i) : kBig;
    if (v > 1) sort8(x);
#pragma unroll
    for (int i = 0; i < kTiny; ++i) {
      if (x[i] != kBig && (i == 0 || x[i] != x[i - 1])) tiny[u++][tid] = x[i];
    }
  }
  // rows for the warp, one at a time: lane i holds window slot i
  unsigned todo = __ballot_sync(kFull, v > kTiny && v <= kWarpRow);
  while (todo) {
    const int r = __ffs(todo) - 1;
    todo &= todo - 1;
    const int rv = __shfl_sync(kFull, v, r), rw = __shfl_sync(kFull, w0, r);
    int64_t x = lane < rv ? load64(pos_enc + rw + lane) : kBig;
    for (int k = 2; k <= 32; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int64_t other = __shfl_xor_sync(kFull, x, j);
        const bool keep_low = ((lane & j) == 0) == ((lane & k) == 0);
        x = (x < other) == keep_low ? x : other;
      }
    }
    const int64_t before = __shfl_up_sync(kFull, x, 1);
    const bool keep = x != kBig && (lane == 0 || x != before);
    const unsigned kept = __ballot_sync(kFull, keep);
    if (keep) {
      positions[(b0 + warp * 32 + r) * capacity + __popc(kept & ((1u << lane) - 1))] = x;
    }
    if (lane == r) u = __popc(kept);
  }
  if (v > kWarpRow) wide_rows[atomicAdd(&n_wide, 1)] = tid;
  row_info[tid] = v <= kTiny ? u : -1 - u;
  __syncthreads();

  // rows for the block, one at a time, sorted in big_row
  for (int q = 0; q < n_wide; ++q) {
    const int r = wide_rows[q];
    const int rv = win_n[r], rw = win_start[r];
    int P = 64;
    while (P < rv) P <<= 1;
    for (int i = tid; i < P; i += kThreads) {
      big_row[i] = i < rv ? load64(pos_enc + rw + i) : kBig;
    }
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < P; i += kThreads) {
          const int p = i ^ j;
          if (p > i) {
            const int64_t a = big_row[i], c = big_row[p];
            if ((a > c) == ((i & k) == 0)) {
              big_row[i] = c;
              big_row[p] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    int64_t* row = positions + (b0 + r) * capacity;
    int base = 0;
    for (int i0 = 0; i0 < P; i0 += kThreads) {
      const int i = i0 + tid;
      const int64_t x = i < P ? big_row[i] : kBig;
      const bool keep = x != kBig && (i == 0 || x != big_row[i - 1]);
      const unsigned kept = __ballot_sync(kFull, keep);
      if (lane == 0) warp_kept[warp] = __popc(kept);
      __syncthreads();
      int at = base + __popc(kept & ((1u << lane) - 1));
      for (int w = 0; w < kWarps; ++w) {
        at += w < warp ? warp_kept[w] : 0;
        base += warp_kept[w];
      }
      if (keep) row[at] = x;
      __syncthreads();
    }
    if (tid == 0) row_info[r] = -1 - base;
    __syncthreads();
  }
  if (b < n) n_unique[b] = row_info[tid] >= 0 ? row_info[tid] : -1 - row_info[tid];

  // --- 2. writing ----------------------------------------------------------
  // the block's rows as one span of slots; b0 * capacity is even, so a pair
  // of slots at an even offset is 16-byte aligned
  const unsigned rows = static_cast<unsigned>(n - b0 < kThreads ? n - b0 : kThreads);
  const unsigned span = rows * capacity, cap = capacity;  // <= 128 * kMaxCapacity
  int64_t* out = positions + b0 * capacity;
  // slot f is slot j of row r; a thread's next pair is 2 * kThreads slots on
  unsigned r = 2 * tid / cap, j = 2 * tid - r * cap;
  const unsigned step_r = 2 * kThreads / cap, step_j = 2 * kThreads - step_r * cap;
  for (unsigned f = 2 * tid; f < span; f += 2 * kThreads) {
    const bool wraps = j + 1 == cap, pair = f + 1 < span;
    const int info0 = row_info[r];
    const int info1 = wraps ? (pair ? row_info[r + 1] : 0) : info0;
    const unsigned r1 = wraps ? r + 1 : r, j1 = wraps ? 0 : j + 1;
    // a row's first u slots are its values: taken from `tiny` when a thread
    // sorted the row, already in place when a warp or the block did
    const bool value0 = static_cast<int>(j) < (info0 >= 0 ? info0 : -1 - info0);
    const bool value1 = static_cast<int>(j1) < (info1 >= 0 ? info1 : -1 - info1);
    const int64_t val0 = (value0 && info0 >= 0) ? tiny[j][r] : -1;
    const int64_t val1 = (pair && value1 && info1 >= 0) ? tiny[j1][r1] : -1;
    const bool mine0 = !value0 || info0 >= 0;
    const bool mine1 = pair && (!value1 || info1 >= 0);
    if (mine0 && mine1) {
      __stcs(reinterpret_cast<longlong2*>(out + f), make_longlong2(val0, val1));
    } else {
      if (mine0) __stcs(reinterpret_cast<long long*>(out + f), val0);
      if (mine1) __stcs(reinterpret_cast<long long*>(out + f + 1), val1);
    }
    r += step_r;
    j += step_j;
    if (j >= cap) {
      j -= cap;
      ++r;
    }
  }
}

template <class K>
int query(const K* run_start, int64_t n_runs, const K* tree, int64_t tree_rows,
          const int64_t* pos_enc, const K* start, const K* end, int64_t n,
          int capacity, int exact, int sort_slots, int64_t* positions,
          int* n_unique, int* n_runs_out, uint8_t* overflow, void* stream) {
  pgt::SearchTree<K> tt;
  if (!pgt::make_search_tree(tree, tree_rows, run_start, n_runs, &tt) ||
      capacity < 1 || capacity > kMaxCapacity || sort_slots < 64 ||
      sort_slots < capacity || (sort_slots & (sort_slots - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const size_t dynamic = static_cast<size_t>(sort_slots) * sizeof(int64_t);
    if (dynamic > 32 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          query_tags_batch_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dynamic));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    query_tags_batch_kernel<K><<<blocks, kThreads, dynamic,
                              static_cast<cudaStream_t>(stream)>>>(
        tt, n_runs, pos_enc, start, end, n, capacity, exact, positions, n_unique,
        n_runs_out, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// run_start [n_runs] int32 (sorted tag run heads), tree [tree_rows, 16]
// int32 (its search tree), pos_enc [n_runs] int64; start/end [n] int32
// inclusive BWT intervals; positions [n, capacity] int64, 16-byte aligned;
// sort_slots: the power of two >= capacity (>= 64) that sizes the block's
// sort buffer
int pgt_query_tags_batch(const int* run_start, int64_t n_runs, const int* tree,
                         int64_t tree_rows, const int64_t* pos_enc,
                         const int* start, const int* end, int64_t n,
                         int capacity, int exact, int sort_slots,
                         int64_t* positions, int* n_unique, int* n_runs_out,
                         uint8_t* overflow, void* stream) {
  return query(run_start, n_runs, tree, tree_rows, pos_enc, start, end, n,
               capacity, exact, sort_slots, positions, n_unique, n_runs_out,
               overflow, stream);
}

// the same over int64 run heads (tree [tree_rows, 8] int64) and int64
// intervals
int pgt_query_tags_batch64(const int64_t* run_start, int64_t n_runs,
                           const int64_t* tree, int64_t tree_rows,
                           const int64_t* pos_enc, const int64_t* start,
                           const int64_t* end, int64_t n, int capacity,
                           int exact, int sort_slots, int64_t* positions,
                           int* n_unique, int* n_runs_out, uint8_t* overflow,
                           void* stream) {
  return query(run_start, n_runs, tree, tree_rows, pos_enc, start, end, n,
               capacity, exact, sort_slots, positions, n_unique, n_runs_out,
               overflow, stream);
}

}  // extern "C"
