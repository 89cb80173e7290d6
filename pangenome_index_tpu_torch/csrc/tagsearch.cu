// The tag-array search alone, one value a thread: the device function that
// K4 and K6 search with (tags.cuh:upper_bound_quad over the 64-byte-node
// tree), launched by itself so that it can be held against searchsorted and
// timed.
//
// Replaces the two jnp.searchsorted calls over the tag run heads in
// ops/tagquery.py:query_tags_batch and query_mem_tags (XLA on the TPU).
//
// What bounds it: the rate at which L1 serves the searches' divergent loads
// (tags.cuh), then the chain of dependent loads of one search: one 64-byte
// line a level, the top levels served by L1. An instantiation for int32
// heads and one for int64 heads (n >= 2^31; 8 keys a line).
#include <cstdint>
#include <cuda_runtime.h>

#include "tags.cuh"

namespace {

template <class K>
__global__ void tag_search_kernel(pgt::SearchTree<K> tree,
                                  const K* __restrict__ values, int64_t n,
                                  int* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const K mine = i < n ? pgt::load_key(values + i) : 0;
  // the quad's four values, searched together
  K v[4];
  int r[4];
  bool active[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[m] = __shfl_sync(0xffffffffu, mine, m, 4);
    active[m] = __shfl_sync(0xffffffffu, i < n ? 1 : 0, m, 4);
  }
  pgt::upper_bound_quad<4>(tree, v, active, r);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if ((threadIdx.x & 3) == m && i < n) out[i] = r[m];
  }
}

constexpr int kThreads = 256;

template <class K>
int search(const K* heads, int64_t t, const K* nodes, int64_t rows,
           const K* values, int64_t n, int* out, void* stream) {
  pgt::SearchTree<K> tree;
  if (!pgt::make_search_tree(nodes, rows, heads, t, &tree)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    tag_search_kernel<K><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tree, values, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// heads [t] int32 sorted, nodes [rows, 16] int32 (derive_search_tree),
// values [n] int32 -> out [n] int32: the number of heads <= each value
int pgt_tag_upper_bound(const int* heads, int64_t t, const int* nodes,
                        int64_t rows, const int* values, int64_t n, int* out,
                        void* stream) {
  return search(heads, t, nodes, rows, values, n, out, stream);
}

// the same over int64 heads, nodes [rows, 8] int64 and int64 values
int pgt_tag_upper_bound64(const int64_t* heads, int64_t t,
                          const int64_t* nodes, int64_t rows,
                          const int64_t* values, int64_t n, int* out,
                          void* stream) {
  return search(heads, t, nodes, rows, values, n, out, stream);
}

}  // extern "C"
