// K8: batched locate, the packed SA values of BWT intervals, one thread an
// interval.
//
// Replaces pangenome_index_tpu/ops/locate.py:locate_batch (with
// ops/rank.py:run_of and locate_next), an XLA program on the TPU that
// advanced every lane a locate_next a step, a while loop to chase each lane
// from its run head to its start, then `capacity` steps writing a column of
// the output each. Per interval (start, size):
//   1. j = run_of(start), the run holding start: a search of run_start;
//   2. cur = samples[j], the SA value at the run head;
//   3. locate_next from the run head up to start, one step a row;
//   4. min(size, capacity) values into the interval's row of `positions`,
//      a locate_next between two, zeros after them;
// locate_next(prev): i = (number of run tails <= prev) - 1 (-1 wrapping to
// r - 1); samples[last_to_run[i] + 1] + (prev - last_sorted[i]).
//
// A lane's steps form one chain of dependent loads, so the kernel is bound
// by its longest lane's chain, not by bytes (at 2.16 G positions the
// longest lane takes some 6000 steps against a mean of some 360). The
// design makes a step two dependent loads. locate_next(prev) is prev +
// delta[i], delta[i] = samples[last_to_run[i] + 1] - last_sorted[i] a
// constant of the tail, so the tails and their deltas are fused into pairs
// (ops/tables.py:derive_tail_index), and the predecessor is found through a
// bucket index over the tails' packed values, about one tail a bucket:
//   1. b = prev >> shift (clamped into the buckets); tail_lo[b] and
//      tail_lo[b + 1], one line: the bucket's tails [lo, hi);
//   2. the pairs lo - 1 .. hi - 1 (the one before the bucket and the
//      bucket's), loads issued together: one line, or two, wherever the
//      bucket holds at most a line of pairs (4 at int64, 8 at int32); a
//      fuller bucket is searched by halving, and its pair loaded;
//   i = lo - 1 + (the bucket's tails <= prev), and the step is prev +
//   delta[i], in unsigned arithmetic: the int32 form wraps as JAX's int32
//   sum does.
// run_of runs once a lane, through the static search tree over run_start
// (ops/tables.py:derive_search_tree) with tags.cuh:upper_bound_quad, a quad
// of lanes taking its four searches together. After it each lane steps on
// by itself, `cur` in a register, and each slot of a row is written once.
// Positions (the tables, the intervals and the output) are int32 below
// n = 2^31 and int64 past it (the position type is a template parameter).
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "tags.cuh"

namespace {

constexpr int kThreads = 128;

// a (tail, delta) pair, read with one load: 8 bytes at int32, 16 at int64
template <class P>
using PairOf = std::conditional_t<sizeof(P) == 4, int2, longlong2>;

// pairs a 64-byte line holds
template <class P>
constexpr int kLinePairs = 64 / static_cast<int>(sizeof(PairOf<P>));

template <class P>
struct LocateTables {
  pgt::SearchTree<P> runs;  // over run_start
  const P* run_start;
  const P* samples;         // [r + 1]
  const PairOf<P>* pairs;   // [r] (last_sorted[i], delta[i])
  const int* tail_lo;       // [nb + 1] the first tail of each bucket, r at nb
  int64_t nb;
  int shift;
  int n_runs;
};

// The number of heads <= v of this lane's search; every lane of the warp
// calls it, a lane that is not active loads nothing and gets no meaning.
template <class P>
__device__ __forceinline__ int search(const pgt::SearchTree<P>& tree, P v,
                                      bool active) {
  P vs[4];
  int r[4];
  bool act[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    vs[m] = __shfl_sync(0xffffffffu, v, m, 4);
    act[m] = __shfl_sync(0xffffffffu, active ? 1 : 0, m, 4);
  }
  pgt::upper_bound_quad<4>(tree, vs, act, r);
  int out = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) out = (threadIdx.x & 3) == m ? r[m] : out;
  return out;
}

// the pair before tail index i (i = 0: the last, as the JAX gather of -1)
template <class P>
__device__ __forceinline__ PairOf<P> pair_before(const LocateTables<P>& t, int i) {
  return __ldg(t.pairs + (i > 0 ? i - 1 : t.n_runs - 1));
}

// locate_next(prev): the bucket, then its pairs (one line where it fits)
template <class P>
__device__ __forceinline__ P locate_next(const LocateTables<P>& t, P prev) {
  using U = std::make_unsigned_t<P>;
  constexpr int K = kLinePairs<P>;
  int64_t b = static_cast<int64_t>(prev) >> t.shift;
  b = b < 0 ? 0 : (b >= t.nb ? t.nb - 1 : b);
  const int lo = __ldg(t.tail_lo + b);
  const int hi = __ldg(t.tail_lo + b + 1);
  const int m = hi > lo ? hi - lo : 0;
  P delta;
  if (m <= K) {
    // p[0] the pair before the bucket, p[1 .. m] the bucket's, loaded together
    PairOf<P> p[K + 1];
    p[0] = pair_before(t, lo);
#pragma unroll
    for (int j = 1; j <= K; ++j) p[j] = j <= m ? __ldg(t.pairs + lo + j - 1) : p[0];
    int c = 0;
#pragma unroll
    for (int j = 1; j <= K; ++j) c += j <= m && static_cast<P>(p[j].x) <= prev;
    delta = static_cast<P>(p[0].y);
#pragma unroll
    for (int j = 1; j <= K; ++j) delta = j == c ? static_cast<P>(p[j].y) : delta;
  } else {
    int l = lo, h = hi;  // the first tail of the bucket above prev
    while (l < h) {
      const int mid = l + (h - l) / 2;
      if (static_cast<P>(__ldg(t.pairs + mid).x) <= prev)
        l = mid + 1;
      else
        h = mid;
    }
    delta = static_cast<P>(pair_before(t, l).y);
  }
  return static_cast<P>(static_cast<U>(prev) + static_cast<U>(delta));
}

template <class P>
__global__ void __launch_bounds__(kThreads)
locate_kernel(LocateTables<P> t, const P* __restrict__ start,
              const P* __restrict__ size, int64_t B, int capacity,
              P* __restrict__ positions, int* __restrict__ count,
              bool* __restrict__ overflow) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = lane < B;
  const P st = live ? pgt::load_key(start + lane) : 0;
  const P sz = live ? pgt::load_key(size + lane) : 0;
  // may be < 0, as in JAX
  const int cnt = sz < capacity ? static_cast<int>(sz) : capacity;
  const int emit = cnt > 0 ? cnt : 0;
  // -1 where start lies before the first run; it reads the last entry of
  // each table, as the JAX and torch gathers do (samples holds n_runs + 1)
  const int j = search(t.runs, st, live) - 1;
  if (!live) return;
  P cur = pgt::load_key(t.samples + (j < 0 ? t.n_runs : j));
  const P head = pgt::load_key(t.run_start + (j < 0 ? t.n_runs - 1 : j));
  // the chase runs while the head is before start (none for a start
  // before the BWT), and not at all for an interval that emits nothing
  P chase = emit > 0 && head < st ? st - head : 0;
  P* row = positions + lane * capacity;
  int e = 0;
  if (chase == 0 && e < emit) row[e++] = cur;
  while (chase > 0 || e < emit) {
    cur = locate_next(t, cur);
    if (chase > 0) --chase;
    if (chase == 0) row[e++] = cur;
  }
  for (; e < capacity; ++e) row[e] = 0;
  count[lane] = cnt;
  overflow[lane] = sz > capacity;
}

template <class P>
int locate(const P* run_start, const P* run_nodes, int64_t run_rows,
           const P* samples, const P* pairs, const int* tail_lo, int64_t nb,
           int shift, int64_t n_runs, const P* start, const P* size, int64_t B,
           int capacity, P* positions, int* count, bool* overflow, void* stream) {
  LocateTables<P> t;
  if (n_runs < 1 || n_runs >= (int64_t{1} << 31) || capacity < 1 || nb < 1 ||
      shift < 0 || shift > 62 ||
      !pgt::make_search_tree(run_nodes, run_rows, run_start, n_runs, &t.runs))
    return static_cast<int>(cudaErrorInvalidValue);
  t.run_start = run_start;
  t.samples = samples;
  t.pairs = reinterpret_cast<const PairOf<P>*>(pairs);
  t.tail_lo = tail_lo;
  t.nb = nb;
  t.shift = shift;
  t.n_runs = static_cast<int>(n_runs);
  if (B > 0) {
    const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
    locate_kernel<P><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        t, start, size, B, capacity, positions, count, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// run_start [r] int32 and its search tree [run_rows, 16] int32, samples
// [r + 1], the tail pairs [r, 2] int32 (last_sorted, delta) and their
// bucket index tail_lo [nb + 1] int32 over buckets of 2^shift values;
// start, size [B] int32 -> positions [B, capacity] int32, count [B] int32
// (min(size, capacity)), overflow [B] bool (size > capacity)
int pgt_locate(const int* run_start, const int* run_nodes, int64_t run_rows,
               const int* samples, const int* pairs, const int* tail_lo,
               int64_t nb, int shift, int64_t n_runs, const int* start,
               const int* size, int64_t B, int capacity, int* positions,
               int* count, bool* overflow, void* stream) {
  return locate(run_start, run_nodes, run_rows, samples, pairs, tail_lo, nb,
                shift, n_runs, start, size, B, capacity, positions, count,
                overflow, stream);
}

// the same over int64 tables (the run tree [rows, 8] int64, the pairs [r, 2]
// int64, 16-byte aligned), intervals and positions; tail_lo stays int32
int pgt_locate64(const int64_t* run_start, const int64_t* run_nodes,
                 int64_t run_rows, const int64_t* samples, const int64_t* pairs,
                 const int* tail_lo, int64_t nb, int shift, int64_t n_runs,
                 const int64_t* start, const int64_t* size, int64_t B,
                 int capacity, int64_t* positions, int* count, bool* overflow,
                 void* stream) {
  return locate(run_start, run_nodes, run_rows, samples, pairs, tail_lo, nb,
                shift, n_runs, start, size, B, capacity, positions, count,
                overflow, stream);
}

}  // extern "C"
