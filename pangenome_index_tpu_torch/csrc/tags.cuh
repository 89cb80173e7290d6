// Tag-array search pieces shared by K4 (tagquery.cu), K6 (tagbatch.cu) and
// the search probe (tagsearch.cu), and the search tree that K8 (locate.cu)
// searches the run heads and the sorted run tails with.
//
// The search over t sorted int32 heads below INT32_MAX ("how many heads are
// <= v", searchsorted side="right": the tag run heads here, run_start and
// last_sorted in locate.cu) goes through a static search tree made for
// 64-byte lines (ops/tables.py:derive_search_tree): a node is one aligned
// line of 16 int32 keys with 17 children, the leaf level is the array of
// heads itself read as lines of 16, and node j at height h covers the leaf
// lines [j * 17^h, (j + 1) * 17^h); its key i is the first head of the leaf
// line where its child i + 1 begins, or INT32_MAX where there is none. A
// descent reads one line a level: 6 dependent trips at 4 M heads where a
// binary search takes 22, and the top levels (1 + 17 + 289 lines = 19 KB)
// are read by every thread and stay in L1.
//
// Four neighbouring lanes (a quad) share a search: each loads 16 bytes of the
// node's line, counts its four keys, and two shuffles add the counts up. A
// thread that reads a whole line by itself makes four loads whose 32 lanes
// touch 32 different lines each, and the searches of a warp are then bound
// by the rate at which L1 serves divergent requests, not by latency; by
// quads a warp's load touches 8 lines, a quarter of the requests for the
// same searches. A quad takes its lanes' searches together, level by level,
// so that their loads are in flight together.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace pgt {

// encoded_start_every_k_run of the reference (tag_arrays.hpp:120)
constexpr int kStartEveryK = 10;
// the "no value" filler of the JAX code: a pos_enc equal to it is never kept
constexpr int64_t kBig = INT64_MAX;
// keys of a tree node (one 64-byte line) and its children
constexpr int kNodeKeys = 16;
constexpr int kFanOut = kNodeKeys + 1;
// internal levels a tree over fewer than 2^31 heads can have
constexpr int kMaxDepth = 7;

__device__ __forceinline__ int64_t load64(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// A search tree as a kernel argument. `nodes` holds the internal levels,
// root first, then one more line: the last leaf line padded to 16 keys with
// INT32_MAX (the heads' own last line may be short). Every head is below
// INT32_MAX (a BWT offset or a packed text position), which
// derive_search_tree checks.
struct SearchTree {
  const int4* nodes;
  const int4* heads;       // the run heads: the leaf level, lines of 16
  int depth;               // internal levels
  int last_line;           // the leaf line that is read from `nodes` ...
  int padded;              // ... where it is this line
  int off[kMaxDepth];      // first line of each internal level
};

// Fills `tree` for t heads and the derived tensor of `rows` lines; false
// when the tensor was not derived from t heads (its line count differs).
inline bool make_search_tree(const int* nodes, int64_t rows, const int* heads,
                          int64_t t, SearchTree* tree) {
  const int64_t lines = t > 0 ? (t + kNodeKeys - 1) / kNodeKeys : 1;
  int depth = 0;
  for (int64_t span = 1; span < lines; span *= kFanOut) ++depth;
  if (depth > kMaxDepth) return false;
  int64_t span = 1;
  for (int d = 0; d < depth; ++d) span *= kFanOut;
  int64_t off = 0;
  for (int d = 0; d < depth; ++d) {  // level d: nodes of height depth - d
    tree->off[d] = static_cast<int>(off);
    off += (lines + span - 1) / span;
    span /= kFanOut;
  }
  for (int d = depth; d < kMaxDepth; ++d) tree->off[d] = 0;
  tree->padded = static_cast<int>(off);
  tree->nodes = reinterpret_cast<const int4*>(nodes);
  tree->heads = reinterpret_cast<const int4*>(heads);
  tree->depth = depth;
  tree->last_line = static_cast<int>(lines - 1);
  return off + 1 == rows;
}

__device__ __forceinline__ int keys_le(const int4& k, int v) {
  return (k.x <= v) + (k.y <= v) + (k.z <= v) + (k.w <= v);
}

// the padding (INT32_MAX) never counts: every head is below it
__device__ __forceinline__ int search_key(int v) {
  return v < INT_MAX ? v : INT_MAX - 1;
}

// the sum of `c` over the four lanes of a quad
__device__ __forceinline__ int quad_sum(int c) {
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  return c + __shfl_xor_sync(0xffffffffu, c, 2);
}

// Number of heads <= v[q] for the N searches of a quad, out[q] in all four
// of its lanes. Every lane of the warp must call it, with v and active the
// same in the four lanes of a quad; a search that is not active loads
// nothing and its out[q] means nothing.
template <int N>
__device__ __forceinline__ void upper_bound_quad(const SearchTree& tree,
                                                 const int (&v)[N],
                                                 const bool (&active)[N],
                                                 int (&out)[N]) {
  const int part = threadIdx.x & 3;  // this lane's 16 bytes of a line
  int key[N], node[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    key[q] = search_key(v[q]);
    node[q] = 0;
  }
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    if (d < tree.depth) {
      int c[N];
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int at = 4 * (tree.off[d] + node[q]) + part;
        c[q] = 0;
        if (active[q]) c[q] = keys_le(__ldg(tree.nodes + at), key[q]);
      }
#pragma unroll
      for (int q = 0; q < N; ++q) node[q] = node[q] * kFanOut + quad_sum(c[q]);
    }
  }
  int c[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int4* line = node[q] == tree.last_line
                           ? tree.nodes + 4 * tree.padded
                           : tree.heads + 4 * static_cast<int64_t>(node[q]);
    c[q] = active[q] ? keys_le(__ldg(line + part), key[q]) : 0;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) out[q] = node[q] * kNodeKeys + quad_sum(c[q]);
}

// The searches of a quad's four lanes, two values a lane (an interval's
// ends): lane m of the quad brings ends[0..1] and whether it searches at
// all; bits[0..1] are its own two results. Every lane of the warp calls it.
__device__ __forceinline__ void upper_bound_ends(const SearchTree& tree,
                                                 const int (&ends)[2],
                                                 bool searches, int (&bits)[2]) {
  int v[8], out[8];
  bool active[8];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[2 * m] = __shfl_sync(0xffffffffu, ends[0], m, 4);
    v[2 * m + 1] = __shfl_sync(0xffffffffu, ends[1], m, 4);
    active[2 * m] = active[2 * m + 1] = __shfl_sync(0xffffffffu, searches ? 1 : 0, m, 4);
  }
  upper_bound_quad<8>(tree, v, active, out);
  bits[0] = bits[1] = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if ((threadIdx.x & 3) == m) {
      bits[0] = out[2 * m];
      bits[1] = out[2 * m + 1];
    }
  }
}

}  // namespace pgt
