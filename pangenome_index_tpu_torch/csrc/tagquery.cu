// K4: per-MEM tag counts, one thread per (read, MEM slot).
//
// Replaces ops/tagquery.py:query_mem_tags, an XLA program on the TPU that
// materialised a [B*M, capacity] window of tag positions and a
// [B*M, capacity, capacity] pairwise-equality mask. Here each thread does two
// upper-bound binary searches over the tag run heads (log2 t dependent loads,
// the top levels shared by every thread and so cache-resident), then reads
// only the window slots that hold runs (run spans are about 1 on pangenome
// workloads) and counts first occurrences with a pairwise loop over those
// slots. Bound by the latency of the binary-search loads; the window reads
// are few and adjacent.
//
// Semantics kept exactly: the mod-10 start quirk of the reference
// (tagquery.py:100, START_EVERY_K), slots past min(count, M) give 0, and a
// slot overflows when its run span exceeds `capacity` (its count then covers
// the first `capacity` runs only).
#include <cstdint>
#include <cuda_runtime.h>

#include "tags.cuh"

namespace {

using pgt::kBig;
using pgt::kStartEveryK;
using pgt::load64;
using pgt::upper_bound;

__global__ void query_mem_tags_kernel(const int* __restrict__ run_start,
                                      int64_t n_runs,
                                      const int64_t* __restrict__ pos_enc,
                                      const int* __restrict__ bwt_start,
                                      const int* __restrict__ size,
                                      const int* __restrict__ count,
                                      int n_reads, int M, int capacity,
                                      int* __restrict__ n_unique,
                                      uint8_t* __restrict__ overflow) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(n_reads) * M) return;
  const int64_t b = e / M;
  const int slot = static_cast<int>(e - b * M);
  const int cnt = __ldg(count + b);
  const bool valid = slot < (cnt < M ? cnt : M);
  const int s = valid ? __ldg(bwt_start + e) : 0;
  const int en = valid ? __ldg(bwt_start + e) + __ldg(size + e) - 1 : 0;
  const int64_t first_bit = upper_bound(run_start, n_runs, s);
  const int64_t end_bit = upper_bound(run_start, n_runs, en);
  const int64_t run_nums = end_bit - first_bit + 1;
  const int64_t rs = (first_bit % kStartEveryK == 0) ? first_bit : first_bit - 1;
  int uniq = 0;
  for (int i = 0; i < capacity; ++i) {
    const int64_t w = rs + i;
    if (!(i < run_nums && w < n_runs && w >= 0)) continue;
    const int64_t v = load64(pos_enc + w);
    bool dup = v == kBig;
    for (int i2 = 0; i2 < i && !dup; ++i2) {
      const int64_t w2 = rs + i2;
      if (i2 < run_nums && w2 < n_runs && w2 >= 0) dup = load64(pos_enc + w2) == v;
    }
    uniq += dup ? 0 : 1;
  }
  n_unique[e] = valid ? uniq : 0;
  overflow[e] = (valid && run_nums > capacity) ? 1 : 0;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// run_start [n_runs] int32 (sorted tag run heads), pos_enc [n_runs] int64;
// bwt_start/size [n_reads, M] int32 MEM buffers, count [n_reads] int32
int pgt_query_mem_tags(const int* run_start, int64_t n_runs,
                       const int64_t* pos_enc, const int* bwt_start,
                       const int* size, const int* count, int n_reads, int M,
                       int capacity, int* n_unique, uint8_t* overflow,
                       void* stream) {
  const int64_t total = static_cast<int64_t>(n_reads) * M;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    query_mem_tags_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        run_start, n_runs, pos_enc, bwt_start, size, count, n_reads, M,
        capacity, n_unique, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
