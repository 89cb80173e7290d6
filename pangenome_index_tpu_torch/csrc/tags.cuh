// Tag-array search pieces shared by K4 (tagquery.cu), K6 (tagbatch.cu) and
// the search probe (tagsearch.cu), and the search tree that K8 (locate.cu)
// finds a start's run with.
//
// The search over t sorted heads below the key type's maximum ("how many
// heads are <= v", searchsorted side="right": the tag run heads here,
// run_start in locate.cu) goes through a static search tree
// made for 64-byte lines (ops/tables.py:derive_search_tree): a node is one
// aligned line of 16 int32 keys with 17 children (8 int64 keys with 9
// children past 2^31), the leaf level is the array of heads itself read as
// lines, and node j at height h covers the leaf lines [j * 17^h,
// (j + 1) * 17^h); its key i is the first head of the leaf line where its
// child i + 1 begins, or the maximum where there is none. A descent reads
// one line a level: 6 dependent trips at 4 M int32 heads where a binary
// search takes 22 (7 for int64 heads), and the top levels (1 + 17 + 289
// lines = 19 KB) are read by every thread and stay in L1. The key type is a
// template parameter; the int32 instantiation is the one that was measured.
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
#include <type_traits>
#include <cuda_runtime.h>

namespace pgt {

__device__ __forceinline__ uint64_t u64_of(int lo, int hi) {
  return static_cast<uint64_t>(static_cast<uint32_t>(lo)) |
         (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32);
}

// encoded_start_every_k_run of the reference (tag_arrays.hpp:120)
constexpr int kStartEveryK = 10;
// the "no value" filler of the JAX code: a pos_enc equal to it is never kept
constexpr int64_t kBig = INT64_MAX;
// A tree node is one 64-byte line: 16 int32 keys with 17 children, or 8
// int64 keys with 9 children over int64 heads (the tag run heads and
// run_start of an index of n >= 2^31 positions). A lane of a quad
// loads 16 bytes of a line either way: four int32 keys or two int64 keys.
template <class K>
struct TreeShape {
  static constexpr int kNodeKeys = 64 / static_cast<int>(sizeof(K));
  static constexpr int kFanOut = kNodeKeys + 1;
  // internal levels a tree over fewer than 2^31 heads can have
  static constexpr int kMaxDepth = sizeof(K) == 4 ? 7 : 9;
  static constexpr K kMax = sizeof(K) == 4 ? static_cast<K>(INT_MAX)
                                           : static_cast<K>(INT64_MAX);
};

__device__ __forceinline__ int64_t load64(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}
// a read-only load of either key type
__device__ __forceinline__ int load_key(const int* p) { return __ldg(p); }
__device__ __forceinline__ int64_t load_key(const int64_t* p) { return load64(p); }

// A search tree as a kernel argument. `nodes` holds the internal levels,
// root first, then one more line: the last leaf line padded with the key
// type's maximum (the heads' own last line may be short). Every head is
// below that maximum (a BWT offset or a packed text position), which
// derive_search_tree checks.
template <class K>
struct SearchTree {
  const int4* nodes;
  const int4* heads;       // the run heads: the leaf level, lines of 64 bytes
  int depth;               // internal levels
  int last_line;           // the leaf line that is read from `nodes` ...
  int padded;              // ... where it is this line
  int off[TreeShape<K>::kMaxDepth];  // first line of each internal level
};

// Fills `tree` for t heads and the derived tensor of `rows` lines; false
// when the tensor was not derived from t heads (its line count differs).
template <class K>
inline bool make_search_tree(const K* nodes, int64_t rows, const K* heads,
                             int64_t t, SearchTree<K>* tree) {
  using S = TreeShape<K>;
  const int64_t lines = t > 0 ? (t + S::kNodeKeys - 1) / S::kNodeKeys : 1;
  int depth = 0;
  for (int64_t span = 1; span < lines; span *= S::kFanOut) ++depth;
  if (depth > S::kMaxDepth) return false;
  int64_t span = 1;
  for (int d = 0; d < depth; ++d) span *= S::kFanOut;
  int64_t off = 0;
  for (int d = 0; d < depth; ++d) {  // level d: nodes of height depth - d
    tree->off[d] = static_cast<int>(off);
    off += (lines + span - 1) / span;
    span /= S::kFanOut;
  }
  for (int d = depth; d < S::kMaxDepth; ++d) tree->off[d] = 0;
  tree->padded = static_cast<int>(off);
  tree->nodes = reinterpret_cast<const int4*>(nodes);
  tree->heads = reinterpret_cast<const int4*>(heads);
  tree->depth = depth;
  tree->last_line = static_cast<int>(lines - 1);
  return off + 1 == rows;
}

// the keys <= v among a lane's 16 bytes of a line
__device__ __forceinline__ int keys_le(const int4& k, int v) {
  return (k.x <= v) + (k.y <= v) + (k.z <= v) + (k.w <= v);
}
__device__ __forceinline__ int keys_le(const int4& k, int64_t v) {
  const int64_t a = static_cast<int64_t>(u64_of(k.x, k.y));
  const int64_t b = static_cast<int64_t>(u64_of(k.z, k.w));
  return (a <= v) + (b <= v);
}

// the padding (the key type's maximum) never counts: every head is below it
template <class K>
__device__ __forceinline__ K search_key(K v) {
  return v < TreeShape<K>::kMax ? v : TreeShape<K>::kMax - 1;
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
template <int N, class K>
__device__ __forceinline__ void upper_bound_quad(const SearchTree<K>& tree,
                                                 const K (&v)[N],
                                                 const bool (&active)[N],
                                                 int (&out)[N]) {
  using S = TreeShape<K>;
  const int part = threadIdx.x & 3;  // this lane's 16 bytes of a line
  K key[N];
  int node[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    key[q] = search_key(v[q]);
    node[q] = 0;
  }
#pragma unroll
  for (int d = 0; d < S::kMaxDepth; ++d) {
    if (d < tree.depth) {
      int c[N];
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int at = 4 * (tree.off[d] + node[q]) + part;
        c[q] = 0;
        if (active[q]) c[q] = keys_le(__ldg(tree.nodes + at), key[q]);
      }
#pragma unroll
      for (int q = 0; q < N; ++q) node[q] = node[q] * S::kFanOut + quad_sum(c[q]);
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
  for (int q = 0; q < N; ++q) out[q] = node[q] * S::kNodeKeys + quad_sum(c[q]);
}

// The searches of a quad's four lanes, two values a lane (an interval's
// ends): lane m of the quad brings ends[0..1] and whether it searches at
// all; bits[0..1] are its own two results. Every lane of the warp calls it.
template <class K>
__device__ __forceinline__ void upper_bound_ends(const SearchTree<K>& tree,
                                                 const K (&ends)[2],
                                                 bool searches, int (&bits)[2]) {
  K v[8];
  int out[8];
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
