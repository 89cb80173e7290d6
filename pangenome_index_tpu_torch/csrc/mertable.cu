// The m-mer seed table, built a level at a time: one thread per parent
// interval, all four children (or sixteen grandchildren) from its one rank
// pair.
//
// Replaces pangenome_index_tpu/ops/mertable.py:84 build_mer_table_device,
// an XLA program on the TPU: a fori_loop over the whole 4^12 key space in
// which every key carries its own interval (the four keys that share a
// parent repeat its rank gathers), then explicit 4x expansion levels, each a
// batched extension of every key. A lane a key needs the state tiled 4x
// between levels and gathers each rank pair four times; a thread a parent
// needs neither.
//
// What bounds it on this card: bytes. The table is 4^m rows of three
// positions (3.2 GB at m = 14, int32) and must be written once; each level
// before it is written once and read once; the rank table is read at most
// once a level (20 MB of checkpoint rows at the bench index, in L2). The
// design:
//   - one thread per parent at level v (parents [4^v, 3], the table layout):
//     it loads the parent, makes the rank pair of (k, k + s) once through
//     the tables' rank provider (rank.cuh: checkpoint rows at int32 or int64
//     positions, dense records, ultra rows, bucketed runs at int32 or
//     int64), and makes the four backward extensions by A, C, G, T (codes
//     1, 2, 3, 5) from it, as ops/fmd.py:extend does one at a time;
//   - child b of parent p has key b << 2v | p, so for each b the warp's 32
//     children are 32 consecutive rows: every store is coalesced, and the
//     last level writes the [4^m, 3] table directly, with no stack and no
//     staging copy;
//   - a parent of size 0 (a key that does not occur) loads nothing and
//     writes (0, 0, 0) children, which is what the host build gives;
//   - depth 2 (the build's last launch, but through int64 bucketed runs):
//     the thread goes on to the children of its four children, their four
//     rank pairs in flight together, and writes sixteen grandchildren, so
//     that level m - 1 never reaches device memory. Through int64 bucketed
//     runs each rank pair is two entries and two 64-byte records, and two
//     one-deep launches are faster (ops/mertable.py:last_depth).
// The row index is 64-bit (4^14 rows).
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 256;

// alphabet code of 2-bit base b (A, C, G, T -> 1, 2, 3, 5)
__device__ __forceinline__ int base_code(int b) { return b + 1 + (b == 3); }

template <class P>
__device__ __forceinline__ void store_row(P* __restrict__ out, int64_t row, P k,
                                          P kp, P s) {
  P* o = out + 3 * row;
  o[0] = k;
  o[1] = kp;
  o[2] = s;
}

// the four backward extensions of (k, kp, s) by A, C, G, T, from one rank
// pair `rows` = rk.load(k, s) (not read when s == 0)
template <class Rank, class P = typename Rank::Pos>
__device__ __forceinline__ void four_children(const Rank& rk,
                                              const typename Rank::Rows& rows,
                                              const P* __restrict__ Cg, P k, P kp,
                                              P s, P (&ck)[4], P (&ckp)[4],
                                              P (&cs)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (s > 0) {
      pgt::extend1(rk, rows, Cg, k, kp, s, base_code(b), false, ck[b], ckp[b],
                   cs[b]);
    } else {
      ck[b] = ckp[b] = cs[b] = 0;
    }
  }
}

template <class Rank, int kDepth, class P = typename Rank::Pos>
__global__ void __launch_bounds__(kThreads)
mer_level_kernel(Rank rk, const P* __restrict__ Cg, const P* __restrict__ parents,
                 int64_t n_parents, int v, P* __restrict__ out) {
  rk.stage();
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n_parents) return;
  const P k = pgt::ld(parents + 3 * p), kp = pgt::ld(parents + 3 * p + 1),
          s = pgt::ld(parents + 3 * p + 2);
  typename Rank::Rows rows;
  if (s > 0) rows = rk.load(k, s);
  P ck[4], ckp[4], cs[4];
  four_children(rk, rows, Cg, k, kp, s, ck, ckp, cs);
  if constexpr (kDepth == 1) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      store_row(out, (static_cast<int64_t>(b) << (2 * v)) | p, ck[b], ckp[b], cs[b]);
  } else {
    typename Rank::Rows crows[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)  // the four children's pairs in flight together
      if (cs[b] > 0) crows[b] = rk.load(ck[b], cs[b]);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      P gk[4], gkp[4], gs[4];
      four_children(rk, crows[b], Cg, ck[b], ckp[b], cs[b], gk, gkp, gs);
      const int64_t child = (static_cast<int64_t>(b) << (2 * v)) | p;
#pragma unroll
      for (int b2 = 0; b2 < 4; ++b2)
        store_row(out, (static_cast<int64_t>(b2) << (2 * v + 2)) | child, gk[b2],
                  gkp[b2], gs[b2]);
    }
  }
}

template <class Rank, class P = typename Rank::Pos>
int launch(const Rank& rk, const P* C, const P* parents, int64_t n_parents, int v,
           int depth, P* out, void* stream) {
  if (v < 0 || v > 15 || n_parents != (int64_t{1} << (2 * v)) || depth < 1 ||
      depth > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n_parents + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (depth == 1)
    mer_level_kernel<Rank, 1><<<blocks, kThreads, 0, st>>>(rk, C, parents, n_parents,
                                                           v, out);
  else
    mer_level_kernel<Rank, 2><<<blocks, kThreads, 0, st>>>(rk, C, parents, n_parents,
                                                           v, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point: the rank provider's tables (as pgt_extend_*), then C,
// parents [4^v, 3] (level v in the table layout), n_parents = 4^v, v, depth
// (1 or 2) and out [4^(v + depth), 3], all in the position type.

int pgt_mer_level_ckpt(const int* ckpt, int64_t nrows, const int* C,
                       const int* parents, int64_t n_parents, int v, int depth,
                       int* out, void* stream) {
  pgt::CkptRank<int> rk{ckpt, static_cast<int>(nrows - 1)};
  return launch(rk, C, parents, n_parents, v, depth, out, stream);
}

int pgt_mer_level_ckpt64(const int* ckpt, int64_t nrows, const int64_t* super_S,
                         int64_t n_super, int super_shift, const int64_t* C,
                         const int64_t* parents, int64_t n_parents, int v, int depth,
                         int64_t* out, void* stream) {
  pgt::CkptRank<int64_t> rk;
  if (!pgt::make_ckpt64(ckpt, nrows, super_S, n_super, super_shift, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, parents, n_parents, v, depth, out, stream);
}

int pgt_mer_level_dense(const int* lines, int64_t n_lines, const int* rec,
                        int64_t n_runs, const int* C, const int* parents,
                        int64_t n_parents, int v, int depth, int* out, void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch(rk, C, parents, n_parents, v, depth, out, stream);
}

int pgt_mer_level_dense64(const int* lines, int64_t n_lines, const int64_t* rec,
                          int64_t n_runs, const int64_t* C, const int64_t* parents,
                          int64_t n_parents, int v, int depth, int64_t* out,
                          void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch(rk, C, parents, n_parents, v, depth, out, stream);
}

int pgt_mer_level_ultra(const int* rank_table, int64_t n_rows, const int* C,
                        const int* parents, int64_t n_parents, int v, int depth,
                        int* out, void* stream) {
  pgt::UltraRank rk{{}, reinterpret_cast<const int4*>(rank_table), n_rows};
  return launch(rk, C, parents, n_parents, v, depth, out, stream);
}

int pgt_mer_level_bucketed(const int* run_index, int64_t n_buckets, int shift,
                           const int* run_rec, const int* run_start, int64_t n_runs, const int* C, const int* parents,
                           int64_t n_parents, int v, int depth, int* out,
                           void* stream) {
  pgt::BucketRank<int> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, parents, n_parents, v, depth, out, stream);
}

int pgt_mer_level_bucketed64(const int* run_index, int64_t n_buckets, int shift,
                             const int64_t* run_rec, const int64_t* run_start, int64_t n_runs, const int64_t* C,
                             const int64_t* parents, int64_t n_parents, int v,
                             int depth, int64_t* out, void* stream) {
  pgt::BucketRank<int64_t> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, parents, n_parents, v, depth, out, stream);
}

}  // extern "C"
