// K4: per-MEM tag counts, one thread per (read, MEM slot).
//
// Replaces ops/tagquery.py:query_mem_tags, an XLA program on the TPU that
// materialised a [B*M, capacity] window of tag positions and a
// [B*M, capacity, capacity] pairwise-equality mask. Here a slot that holds
// no MEM (slot >= min(count, M)) brings no search and writes its 0; every
// other slot's run range comes from two searches through the tag search
// tree, which the four lanes of a quad make together for their four slots
// (tags.cuh); the thread then reads only the window slots that hold runs
// (run spans are about 1 on pangenome workloads) and counts first
// occurrences.
//
// What bounds it: the searches: one 64-byte tree line a level (6 levels at
// 4 M run heads) for each of 2 x 131072 searches at the serving shape, read
// by quads so that a warp's load touches 8 lines and not 32; the eight
// searches of a quad descend together, so their loads overlap. At
// capacities up to 8 (serving runs 8) the window is loaded once into
// registers and deduplicated there; larger capacities take the general
// loop, which reads a window slot again for each later slot.
//
// Semantics kept exactly: the mod-10 start quirk of the reference
// (tagquery.py:100, START_EVERY_K), slots past min(count, M) give 0, and a
// slot overflows when its run span exceeds `capacity` (its count then covers
// the first `capacity` runs only).
//
// The run heads and MEM buffers are int32 below 2^31 BWT rows and int64 past
// it (a tree line of 8 keys); the key type is a template parameter.
#include <cstdint>
#include <cuda_runtime.h>

#include "tags.cuh"

namespace {

using pgt::kBig;
using pgt::kStartEveryK;
using pgt::load64;

// capacities up to this keep the window in registers
constexpr int kRegWindow = 8;

template <bool kInRegisters, class K>
__global__ void query_mem_tags_kernel(pgt::SearchTree<K> tree, int64_t n_runs,
                                      const int64_t* __restrict__ pos_enc,
                                      const K* __restrict__ bwt_start,
                                      const K* __restrict__ size,
                                      const int* __restrict__ count,
                                      int n_reads, int M, int capacity,
                                      int* __restrict__ n_unique,
                                      uint8_t* __restrict__ overflow) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = e < static_cast<int64_t>(n_reads) * M;
  K s = 0, z = 0;
  bool holds_mem = false;
  if (in_range) {
    const int64_t b = e / M;
    const int slot = static_cast<int>(e - b * M);
    // the three loads do not wait for each other
    const int cnt = __ldg(count + b);
    s = pgt::load_key(bwt_start + e);
    z = pgt::load_key(size + e);
    holds_mem = slot < (cnt < M ? cnt : M);
  }
  // the searches belong to quads of lanes: every lane goes in, a slot
  // without a MEM brings no search
  const K ends[2] = {s, s + z - 1};
  int bits[2];
  pgt::upper_bound_ends(tree, ends, holds_mem, bits);
  if (!in_range) return;
  if (!holds_mem) {
    n_unique[e] = 0;
    overflow[e] = 0;
    return;
  }
  const int64_t first_bit = bits[0];
  const int64_t run_nums = static_cast<int64_t>(bits[1]) - first_bit + 1;
  const int64_t rs = (first_bit % kStartEveryK == 0) ? first_bit : first_bit - 1;
  // valid window slots: max(0, -rs) <= i < min(run_nums, capacity, t - rs)
  const int64_t lo = rs < 0 ? -rs : 0;
  int64_t hi = run_nums < capacity ? run_nums : capacity;
  hi = hi < n_runs - rs ? hi : n_runs - rs;
  int uniq = 0;
  if (kInRegisters) {
    int64_t w[kRegWindow];
#pragma unroll
    for (int i = 0; i < kRegWindow; ++i) {
      w[i] = (i >= lo && i < hi) ? load64(pos_enc + rs + i) : kBig;
    }
#pragma unroll
    for (int i = 0; i < kRegWindow; ++i) {
      bool dup = w[i] == kBig;
#pragma unroll
      for (int i2 = 0; i2 < i; ++i2) dup = dup || w[i2] == w[i];
      uniq += dup ? 0 : 1;
    }
  } else {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t v = load64(pos_enc + rs + i);
      bool dup = v == kBig;
      for (int64_t i2 = lo; i2 < i && !dup; ++i2) dup = load64(pos_enc + rs + i2) == v;
      uniq += dup ? 0 : 1;
    }
  }
  n_unique[e] = uniq;
  overflow[e] = run_nums > capacity ? 1 : 0;
}

constexpr int kThreads = 256;

template <class K>
int query(const K* run_start, int64_t n_runs, const K* tree, int64_t tree_rows,
          const int64_t* pos_enc, const K* bwt_start, const K* size,
          const int* count, int n_reads, int M, int capacity, int* n_unique,
          uint8_t* overflow, void* stream) {
  pgt::SearchTree<K> tt;
  if (!pgt::make_search_tree(tree, tree_rows, run_start, n_runs, &tt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(n_reads) * M;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (capacity <= kRegWindow) {
      query_mem_tags_kernel<true, K><<<blocks, kThreads, 0, s>>>(
          tt, n_runs, pos_enc, bwt_start, size, count, n_reads, M, capacity,
          n_unique, overflow);
    } else {
      query_mem_tags_kernel<false, K><<<blocks, kThreads, 0, s>>>(
          tt, n_runs, pos_enc, bwt_start, size, count, n_reads, M, capacity,
          n_unique, overflow);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// run_start [n_runs] int32 (sorted tag run heads), tree [tree_rows, 16]
// int32 (its search tree), pos_enc [n_runs] int64; bwt_start/size
// [n_reads, M] int32 MEM buffers, count [n_reads] int32
int pgt_query_mem_tags(const int* run_start, int64_t n_runs, const int* tree,
                       int64_t tree_rows, const int64_t* pos_enc,
                       const int* bwt_start, const int* size, const int* count,
                       int n_reads, int M, int capacity, int* n_unique,
                       uint8_t* overflow, void* stream) {
  return query(run_start, n_runs, tree, tree_rows, pos_enc, bwt_start, size,
               count, n_reads, M, capacity, n_unique, overflow, stream);
}

// the same over int64 run heads (tree [tree_rows, 8] int64) and int64 MEM
// buffers
int pgt_query_mem_tags64(const int64_t* run_start, int64_t n_runs,
                         const int64_t* tree, int64_t tree_rows,
                         const int64_t* pos_enc, const int64_t* bwt_start,
                         const int64_t* size, const int* count, int n_reads,
                         int M, int capacity, int* n_unique, uint8_t* overflow,
                         void* stream) {
  return query(run_start, n_runs, tree, tree_rows, pos_enc, bwt_start, size,
               count, n_reads, M, capacity, n_unique, overflow, stream);
}

}  // extern "C"
