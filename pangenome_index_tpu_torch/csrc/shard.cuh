// A model shard's partial rank6 at one position, as device functions: the
// bodies of csrc/shard.cu's kernels (3a over checkpoint bit-plane rows, 3b
// over runs), which the lockstep MEM step (csrc/memstep.cu) also calls for
// the positions it has just made, and the table of the shards a process
// holds that the step takes by value.
//
// Exactly one shard owns each position: its partial is the position's
// rank6 over the shard's slice, every other shard's is 0 (see shard.cu).
#pragma once

#include <cstdint>

#include "rank.cuh"

namespace pgt {

// Checkpoint rows [row0, row0 + rows_local) of ops/tables.py:
// derive_rank_planes: the owner holds row p >> 6 and counts each code's
// S[q + 1] - S[q] plus one popcount of the row's positions before p whose
// planes spell q = comp(code). Returns whether it owns p (r is 0 if not).
template <class P>
__device__ __forceinline__ bool ckpt_partial(const int* __restrict__ planes,
                                             int64_t rows_local, int64_t row0, P p,
                                             P (&r)[6]) {
  const int64_t l = static_cast<int64_t>(p >> 6) - row0;
  const bool owns = l >= 0 && l < rows_local;
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = 0;
  if (owns) {
    const int4* row = reinterpret_cast<const int4*>(planes + 16 * l);
    const int4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2), d = __ldg(row + 3);
    const uint64_t p0 = u64(a.x, a.y), p1 = u64(a.z, a.w), p2 = u64(b.x, b.y);
    // S[0..6]: the positions before the row with q < j (pairs overlap:
    // words 6, 7 = S[1], S[2]; 9, 11, 13, 15 = S[3..6])
    const int S[7] = {0, b.z, b.w, c.y, c.w, d.y, d.w};
    const uint64_t before = (1ull << (static_cast<int64_t>(p) & 63)) - 1;
#pragma unroll
    for (int code = 0; code < 6; ++code) {
      const int q = comp_code(code);
      const uint64_t c0 = 0ull - (q & 1), c1 = 0ull - ((q >> 1) & 1), c2 = 0ull - ((q >> 2) & 1);
      const uint64_t eq = ~((p0 ^ c0) | (p1 ^ c1) | (p2 ^ c2));
      r[code] = static_cast<P>(S[q + 1] - S[q] + __popcll(eq & before));
    }
  }
  return owns;
}

// Runs [j0, j0 + runs_local) of run_start, run_sym and cum: p's run is its
// predecessor among the local heads (a binary search), owned where it lies
// before `upper`, the next shard's first head; rank6 = cum[j] +
// onehot(sym[j]) * (p - run_start[j]). Returns whether it owns p.
template <class P>
__device__ __forceinline__ bool run_partial(const P* __restrict__ run_start,
                                            const int8_t* __restrict__ run_sym,
                                            const P* __restrict__ cum, int64_t runs_local,
                                            P upper, P p, P (&r)[6]) {
  int64_t lo = 0, hi = runs_local;  // the first local head > p
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ld(run_start + mid) <= p) lo = mid + 1;
    else hi = mid;
  }
  const int64_t j = lo - 1;
  const bool owns = j >= 0 && p < upper;
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = 0;
  if (owns) {
    const P extra = p - ld(run_start + j);
    const int sym = __ldg(run_sym + j);
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c] = ld(cum + 6 * j + c) + (sym == c ? extra : P{0});
  }
  return owns;
}

// The shards a process holds, by value in a kernel's parameters: one under
// a mesh, or every virtual shard of one card, in ascending `lo`.
constexpr int kMaxShards = 16;
constexpr int kShardsCkpt = 1, kShardsRuns = 2;

struct Shard {
  const void* a;       // planes [count, 16] int32, or run_start [count]
  const int8_t* sym;   // run_sym [count] (runs)
  const void* cum;     // cum [count, 6] (runs)
  int64_t lo;          // the first global row (checkpoint) or head (runs)
  int64_t count;       // rows or runs
  int64_t upper;       // the next shard's first head (runs)
};

struct ShardTable {
  Shard e[kMaxShards];
  int n;
};

// The partial rank6 at p of the one shard of `t` that may own it: the last
// whose `lo` is at most p's row (checkpoint) or p (runs), found by a binary
// search over the table, then that shard's own body. With every shard of
// the index in the table this is p's rank6; with one, its partial.
template <int Kind, class P>
__device__ __forceinline__ void shard_rank6(const ShardTable& t, P p, P (&r)[6]) {
  const int64_t key = Kind == kShardsCkpt ? static_cast<int64_t>(p >> 6) : static_cast<int64_t>(p);
  int i = 0;
#pragma unroll
  for (int w = kMaxShards / 2; w > 0; w >>= 1)
    if (i + w < t.n && t.e[i + w].lo <= key) i += w;
  const Shard& s = t.e[i];
  if constexpr (Kind == kShardsCkpt)
    ckpt_partial(static_cast<const int*>(s.a), s.count, s.lo, p, r);
  else
    run_partial(static_cast<const P*>(s.a), s.sym, static_cast<const P*>(s.cum), s.count,
                static_cast<P>(s.upper), p, r);
}

}  // namespace pgt
