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
// locate_next(prev): i = (number of run tails <= prev) - 1, a search of
// last_sorted; samples[last_to_run[i] + 1] + (prev - last_sorted[i]).
//
// Both searches go through the static search trees of ops/tables.py
// (derive_search_tree over run_start and over last_sorted) with
// tags.cuh:upper_bound_quad: a quad of lanes takes its four searches
// together, one 64-byte line a level. A lane's steps form one chain of
// dependent loads (tree depth + 1 lines of the search, then last_to_run and
// samples), so the kernel is bound by the longest lane's chain, not by bytes;
// its loop runs while any lane of the warp has a step left (every lane takes
// part in the quads' searches), `cur` stays in a register, and each slot of
// a row is written once. Positions (the tables, the intervals and the output)
// are int32 below n = 2^31 and int64 past it, with int64 search trees of 8
// keys a line (tags.cuh); the position type is a template parameter.
#include <cstdint>
#include <cuda_runtime.h>

#include "tags.cuh"

namespace {

constexpr int kThreads = 128;

template <class P>
struct LocateTables {
  pgt::SearchTree<P> runs;   // over run_start
  pgt::SearchTree<P> tails;  // over last_sorted
  const P* run_start;
  const P* samples;     // [r + 1]
  const P* last_sorted;
  const P* last_to_run;
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

// an index of -1 reads the last entry, as the JAX and torch gathers do
__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }

// locate_next(prev) for an active lane, prev itself for another
template <class P>
__device__ __forceinline__ P locate_next(const LocateTables<P>& t, P prev,
                                         bool active) {
  const int i = wrap(search(t.tails, prev, active) - 1, t.n_runs);
  if (!active) return prev;
  const P run = pgt::load_key(t.last_to_run + i) + 1;
  return pgt::load_key(t.samples + run) + (prev - pgt::load_key(t.last_sorted + i));
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
  P cur = 0, chase = 0;
  if (live) {
    cur = pgt::load_key(t.samples + (j < 0 ? t.n_runs : j));
    const P head = pgt::load_key(t.run_start + (j < 0 ? t.n_runs - 1 : j));
    // the chase runs while the head is before start (none for a start
    // before the BWT), and not at all for an interval that emits nothing
    chase = emit > 0 && head < st ? st - head : 0;
  }
  P* row = positions + lane * capacity;
  int e = 0;
  if (live && chase == 0 && e < emit) row[e++] = cur;
  bool step = live && (chase > 0 || e < emit);
  while (__any_sync(0xffffffffu, step)) {
    cur = locate_next(t, cur, step);
    if (step) {
      if (chase > 0) --chase;
      if (chase == 0) row[e++] = cur;
    }
    step = live && (chase > 0 || e < emit);
  }
  if (live) {
    for (; e < capacity; ++e) row[e] = 0;
    count[lane] = cnt;
    overflow[lane] = sz > capacity;
  }
}

template <class P>
int locate(const P* run_start, const P* run_nodes, int64_t run_rows,
           const P* samples, const P* last_sorted, const P* last_to_run,
           const P* tail_nodes, int64_t tail_rows, int64_t n_runs,
           const P* start, const P* size, int64_t B, int capacity,
           P* positions, int* count, bool* overflow, void* stream) {
  LocateTables<P> t;
  if (n_runs < 1 || n_runs >= (int64_t{1} << 31) || capacity < 1 ||
      !pgt::make_search_tree(run_nodes, run_rows, run_start, n_runs, &t.runs) ||
      !pgt::make_search_tree(tail_nodes, tail_rows, last_sorted, n_runs,
                             &t.tails))
    return static_cast<int>(cudaErrorInvalidValue);
  t.run_start = run_start;
  t.samples = samples;
  t.last_sorted = last_sorted;
  t.last_to_run = last_to_run;
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
// [r + 1], last_sorted [r] and its tree [tail_rows, 16], last_to_run [r];
// start, size [B] int32 -> positions [B, capacity] int32, count [B] int32
// (min(size, capacity)), overflow [B] bool (size > capacity)
int pgt_locate(const int* run_start, const int* run_nodes, int64_t run_rows,
               const int* samples, const int* last_sorted,
               const int* last_to_run, const int* tail_nodes,
               int64_t tail_rows, int64_t n_runs, const int* start,
               const int* size, int64_t B, int capacity, int* positions,
               int* count, bool* overflow, void* stream) {
  return locate(run_start, run_nodes, run_rows, samples, last_sorted,
                last_to_run, tail_nodes, tail_rows, n_runs, start, size, B,
                capacity, positions, count, overflow, stream);
}

// the same over int64 tables (trees [rows, 8] int64), intervals and
// positions
int pgt_locate64(const int64_t* run_start, const int64_t* run_nodes,
                 int64_t run_rows, const int64_t* samples,
                 const int64_t* last_sorted, const int64_t* last_to_run,
                 const int64_t* tail_nodes, int64_t tail_rows, int64_t n_runs,
                 const int64_t* start, const int64_t* size, int64_t B,
                 int capacity, int64_t* positions, int* count, bool* overflow,
                 void* stream) {
  return locate(run_start, run_nodes, run_rows, samples, last_sorted,
                last_to_run, tail_nodes, tail_rows, n_runs, start, size, B,
                capacity, positions, count, overflow, stream);
}

}  // extern "C"
