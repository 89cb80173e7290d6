// A model shard's partial rank6 at one position, as device functions: the
// bodies of csrc/shard.cu's kernels (3a over checkpoint bit-plane rows, 3b
// over runs through the shard's slice of the run index), which the lockstep
// MEM step (csrc/memstep.cu) also calls for the positions it has just made
// (both of a read's at once), and the table of the shards a process holds
// that the step takes by value.
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

// A run shard: runs [j0, j0 + count) of the padded tables, which own the
// positions [lo, upper): lo its first head, upper the next shard's (the
// type's maximum on the last). Its run index (rank.cuh:RunIndex) is the
// tables' sliced to the buckets of its heads, with run ids rebased to the
// shard's runs (ops/tables.py:slice_run_index; ops/shard_rank.py:run_shard
// derives one from a slice alone), over its records and heads.
// Ownership is checked first, so a position another shard owns costs no
// load; an owned one takes two dependent loads, its entry and its run's
// record. Returns whether it owns p (r is 0 if not).
template <class P>
__device__ __forceinline__ bool run_partial(const RunIndex<P>& ix, P lo, P upper, P p,
                                            P (&r)[6]) {
  const bool owns = p >= lo && p < upper;
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = 0;
  if (owns) {
    int d;
    const int4 e = ix.entry(p, d);
    ix.rank6_at(p, ix.run(e, d, p), r);
  }
  return owns;
}

// The shards a process holds, by value in a kernel's parameters: one under
// a mesh, or every virtual shard of one card, in ascending `lo`.
constexpr int kMaxShards = 16;
constexpr int kShardsCkpt = 1, kShardsRuns = 2;
// int64 values a shard takes in the host's table (ops/shard_rank.py)
constexpr int kShardFields = 9;

struct Shard {
  const void* a;       // planes [count, 16] int32, or the run records [count, 8]
  const int4* index;   // the run index slice [n_buckets] (runs)
  const void* heads;   // run_start [count] (runs)
  int64_t lo;          // the first global row (checkpoint) or head (runs)
  int64_t count;       // rows or runs
  int64_t upper;       // the next shard's first head (runs)
  int64_t first;       // the run index's first bucket (runs)
  int64_t n_buckets;   // its buckets (runs)
  int64_t shift;       // its bucket shift (runs)
};

struct ShardTable {
  Shard e[kMaxShards];
  int n;
};

template <class P>
__device__ __forceinline__ RunIndex<P> run_index_of(const Shard& s) {
  return RunIndex<P>{s.index, s.n_buckets, s.first, static_cast<int>(s.shift),
                     static_cast<const P*>(s.a), static_cast<const P*>(s.heads), s.count};
}

// The shard of `t` that may own p: the last whose `lo` is at most p's row
// (checkpoint) or p (runs), by a binary search over the table
template <int Kind, class P>
__device__ __forceinline__ const Shard& shard_of(const ShardTable& t, P p) {
  const int64_t key = Kind == kShardsCkpt ? static_cast<int64_t>(p >> 6) : static_cast<int64_t>(p);
  int i = 0;
#pragma unroll
  for (int w = kMaxShards / 2; w > 0; w >>= 1)
    if (i + w < t.n && t.e[i + w].lo <= key) i += w;
  return t.e[i];
}

// The partial rank6 at p of the one shard of `t` that may own it, by that
// shard's own body. With every shard of the index in the table this is
// p's rank6; with one, its partial.
template <int Kind, class P>
__device__ __forceinline__ void shard_rank6(const ShardTable& t, P p, P (&r)[6]) {
  const Shard& s = shard_of<Kind>(t, p);
  if constexpr (Kind == kShardsCkpt)
    ckpt_partial(static_cast<const int*>(s.a), s.count, s.lo, p, r);
  else
    run_partial(run_index_of<P>(s), static_cast<P>(s.lo), static_cast<P>(s.upper), p, r);
}

// The partials at two positions (the two ends of an interval): through runs
// both owned entries are loaded together, then both records, so that the
// pair is two round trips.
template <int Kind, class P>
__device__ __forceinline__ void shard_rank6_pair(const ShardTable& t, P p0, P p1,
                                                 P (&r0)[6], P (&r1)[6]) {
  if constexpr (Kind == kShardsCkpt) {
    shard_rank6<Kind>(t, p0, r0);
    shard_rank6<Kind>(t, p1, r1);
  } else {
    const Shard& s0 = shard_of<Kind>(t, p0);
    const Shard& s1 = shard_of<Kind>(t, p1);
    const bool o0 = p0 >= static_cast<P>(s0.lo) && p0 < static_cast<P>(s0.upper);
    const bool o1 = p1 >= static_cast<P>(s1.lo) && p1 < static_cast<P>(s1.upper);
    const RunIndex<P> x0 = run_index_of<P>(s0), x1 = run_index_of<P>(s1);
    int d0 = 0, d1 = 0;
    int4 e0 = make_int4(0, 0, 0, 0), e1 = make_int4(0, 0, 0, 0);
    if (o0) e0 = x0.entry(p0, d0);
    if (o1) e1 = x1.entry(p1, d1);
    P v0[8], v1[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v0[c] = v1[c] = 0;
    if (o0) x0.record(x0.run(e0, d0, p0), v0);
    if (o1) x1.record(x1.run(e1, d1, p1), v1);
    RunIndex<P>::rank6_of(v0, p0, r0);
    RunIndex<P>::rank6_of(v1, p1, r1);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      r0[c] = o0 ? r0[c] : P{0};
      r1[c] = o1 ? r1[c] : P{0};
    }
  }
}

}  // namespace pgt
