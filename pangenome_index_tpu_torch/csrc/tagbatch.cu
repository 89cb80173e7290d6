// K6: batched tag-array interval queries with position lists, one thread
// per query.
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
// What bounds it: the two binary searches (log2 t dependent loads, the top
// levels shared by all threads and so cache-resident), then the window
// loads. The design loads only the v valid slots (v is about 1 on
// pangenome workloads, while the command line's capacity is 256) and
// insertion-sorts them with dedupe in place in the thread's output row, so
// the work scales with v, not with the capacity; the -1 fill is the only
// per-slot work. At large v (intervals spanning hundreds of runs) the
// insertion sort is O(v^2) global-memory steps per thread; a block-wide
// sort of such rows is a later design.
#include <cstdint>
#include <cuda_runtime.h>

#include "tags.cuh"

namespace {

using pgt::kBig;
using pgt::kStartEveryK;
using pgt::load64;
using pgt::upper_bound;

__global__ void query_tags_batch_kernel(
    const int* __restrict__ run_start, int64_t n_runs,
    const int64_t* __restrict__ pos_enc, const int* __restrict__ start,
    const int* __restrict__ end, int64_t n, int capacity, int exact,
    int64_t* __restrict__ positions, int* __restrict__ n_unique,
    int* __restrict__ n_runs_out, uint8_t* __restrict__ overflow) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int64_t first_bit = upper_bound(run_start, n_runs, __ldg(start + b));
  const int64_t end_bit = upper_bound(run_start, n_runs, __ldg(end + b));
  const int64_t run_nums = end_bit - first_bit + 1;
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
  int64_t* row = positions + b * capacity;
  int u = 0;  // distinct values so far, ascending in row[0, u)
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t v = load64(pos_enc + s + i);
    if (v == kBig) continue;
    int j = u;
    while (j > 0 && row[j - 1] > v) --j;
    if (j > 0 && row[j - 1] == v) continue;
    for (int k = u; k > j; --k) row[k] = row[k - 1];
    row[j] = v;
    ++u;
  }
  for (int k = u; k < capacity; ++k) row[k] = -1;
  n_unique[b] = u;
  n_runs_out[b] = static_cast<int>(run_nums);
  overflow[b] = run_nums > capacity ? 1 : 0;
}

constexpr int kThreads = 64;

}  // namespace

extern "C" {

// run_start [n_runs] int32 (sorted tag run heads), pos_enc [n_runs] int64;
// start/end [n] int32 inclusive BWT intervals; positions [n, capacity] int64
int pgt_query_tags_batch(const int* run_start, int64_t n_runs,
                         const int64_t* pos_enc, const int* start,
                         const int* end, int64_t n, int capacity, int exact,
                         int64_t* positions, int* n_unique, int* n_runs_out,
                         uint8_t* overflow, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    query_tags_batch_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        run_start, n_runs, pos_enc, start, end, n, capacity, exact, positions,
        n_unique, n_runs_out, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
