// The model-sharded rank6: one shard's partial rank vectors, over a slice of
// the checkpoint rows or of the run table.
//
// Replaces parallel/sharding.py:distributed_ckpt_rank6 and distributed_rank6
// (XLA programs under shard_map on the TPU, each followed by a psum over the
// 'model' axis). Exactly one shard owns each position: the owner writes the
// position's rank6 from its slice, every other shard 0, and the sum over the
// shards (one all_reduce over the model group, or, with every shard on one
// card, the launches of the shards into one output with `accumulate` set) is
// the rank6 of the whole index. The collective runs outside the kernel, as
// NCCL does.
//
//   pgt_shard_ckpt_rank6  the shard holds bit-plane rows [row0, row0 +
//                         rows_local) of ops/tables.py:derive_rank_planes;
//                         a position's row is pos >> 6, and its owner counts
//                         each code's S[q + 1] - S[q] plus one popcount of
//                         the row's positions before pos whose planes spell
//                         q = comp(code). Two-level rows (n >= 2^31) give
//                         counts relative to their superblock: the caller
//                         adds the superblock base after the sum, as the JAX
//                         program does after its psum.
//   pgt_shard_run_rank6   the shard holds runs [j0, j0 + runs_local) as
//                         their records and heads and its slice of the run
//                         index (rank.cuh:RunIndex); it owns the positions
//                         [lo, upper): lo its first head, upper the next
//                         shard's (the type's maximum on the last shard),
//                         gathered once when the tables are placed where the
//                         JAX program ppermutes it on every call. Ownership
//                         is checked first (a position another shard owns
//                         costs no load); then the position's bucket entry
//                         and its run's record, two dependent loads; rank6 =
//                         cum[j] + onehot(sym[j]) * (pos - run_start[j]).
//
// What bounds them: bytes. A position reads its 4 or 8 bytes, one 64-byte row
// (or its 16-byte entry and its run's 32- or 64-byte record) and writes 6
// counts, 24 or 48 bytes; a shard that does not own the position writes
// zeros, or nothing when it accumulates. One thread a position; the rows are
// random reads, so the loads of the row are issued together. The bodies are
// csrc/shard.cuh's, which the lockstep MEM step (csrc/memstep.cu) also calls:
// the model-sharded engine no longer launches these kernels, which serve
// parallel/sharding.py:distributed_ckpt_rank6 and distributed_rank6.
#include <cstdint>

#include <cuda_runtime.h>

#include "shard.cuh"

namespace {

constexpr int kThreads = 256;

template <class P>
__device__ __forceinline__ void put6(P* __restrict__ out, int64_t i, const P (&r)[6],
                                     bool owns, int accumulate) {
  P* o = out + 6 * i;
  if (accumulate) {
    if (!owns) return;
#pragma unroll
    for (int c = 0; c < 6; ++c) o[c] += r[c];
  } else {
#pragma unroll
    for (int c = 0; c < 6; ++c) o[c] = owns ? r[c] : P{0};
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads)
shard_ckpt_kernel(const int* __restrict__ planes, int64_t rows_local, int64_t row0,
                  const P* __restrict__ pos, int64_t npos, P* __restrict__ out,
                  int accumulate) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= npos) return;
  P r[6];
  const bool owns = pgt::ckpt_partial(planes, rows_local, row0, pos[i], r);
  put6(out, i, r, owns, accumulate);
}

template <class P>
__global__ void __launch_bounds__(kThreads)
shard_run_kernel(const pgt::RunIndex<P> ix, P lo, P upper, const P* __restrict__ pos,
                 int64_t npos, P* __restrict__ out, int accumulate) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= npos) return;
  P r[6];
  const bool owns = pgt::run_partial(ix, lo, upper, pos[i], r);
  put6(out, i, r, owns, accumulate);
}

template <class P>
int ckpt_launch(const int* planes, int64_t rows_local, int64_t row0, const P* pos,
                int64_t npos, P* out, int accumulate, void* stream) {
  if (rows_local < 1 || npos < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (npos == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((npos + kThreads - 1) / kThreads);
  shard_ckpt_kernel<P><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, rows_local, row0, pos, npos, out, accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
int run_launch(const P* rec, const int* index, int64_t n_buckets, int64_t first, int shift,
               const P* run_start, int64_t runs_local, P lo, P upper, const P* pos,
               int64_t npos, P* out, int accumulate, void* stream) {
  if (runs_local < 1 || n_buckets < 1 || shift < 0 || shift > 15 || npos < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (npos == 0) return 0;
  const pgt::RunIndex<P> ix{reinterpret_cast<const int4*>(index), n_buckets, first, shift,
                            rec, run_start, runs_local};
  const unsigned blocks = static_cast<unsigned>((npos + kThreads - 1) / kThreads);
  shard_run_kernel<P><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ix, lo, upper, pos, npos, out, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// A shard's rank6 partials over its checkpoint rows: planes [rows_local, 16]
// int32 (global rows row0 .. row0 + rows_local - 1), pos [npos] int32 ->
// out [npos, 6] int32 (written, or added to where accumulate is set).
int pgt_shard_ckpt_rank6(const int* planes, int64_t rows_local, int64_t row0, const int* pos,
                         int64_t npos, int* out, int accumulate, void* stream) {
  return ckpt_launch(planes, rows_local, row0, pos, npos, out, accumulate, stream);
}

// the same with int64 positions and partials (two-level rows: relative to
// the superblock)
int pgt_shard_ckpt_rank6_64(const int* planes, int64_t rows_local, int64_t row0,
                            const int64_t* pos, int64_t npos, int64_t* out, int accumulate,
                            void* stream) {
  return ckpt_launch(planes, rows_local, row0, pos, npos, out, accumulate, stream);
}

// A shard's rank6 partials over its runs: the run records [runs_local, 8],
// its run index slice [n_buckets, 4] int32 (buckets of 2^shift positions
// from bucket `first` on), run_start [runs_local], lo and upper (its first
// head and the next shard's, int32 maximum on the last), pos [npos] -> out
// [npos, 6], all int32 but the index.
int pgt_shard_run_rank6(const int* rec, const int* index, int64_t n_buckets, int64_t first,
                        int shift, const int* run_start, int64_t runs_local, int lo,
                        int upper, const int* pos, int64_t npos, int* out, int accumulate,
                        void* stream) {
  return run_launch(rec, index, n_buckets, first, shift, run_start, runs_local, lo, upper,
                    pos, npos, out, accumulate, stream);
}

// the same with int64 records, heads, positions and partials
int pgt_shard_run_rank6_64(const int64_t* rec, const int* index, int64_t n_buckets,
                           int64_t first, int shift, const int64_t* run_start,
                           int64_t runs_local, int64_t lo, int64_t upper,
                           const int64_t* pos, int64_t npos, int64_t* out, int accumulate,
                           void* stream) {
  return run_launch(rec, index, n_buckets, first, shift, run_start, runs_local, lo, upper,
                    pos, npos, out, accumulate, stream);
}

}  // extern "C"
