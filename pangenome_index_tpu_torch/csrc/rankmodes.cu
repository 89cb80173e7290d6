// The ultra and bucketed rank providers alone: rank6 of a batch of
// positions, one thread a position.
//
// Replace the two remaining forms of ops/rank.py:rank6 (XLA on the TPU):
// ultra, a gather of rank_table[pos][:6] (ops/rank.py:165-166, the table of
// ops/tables.py:218-222), and bucketed, run_of's bucket jump and seven
// halving probes over run_start (ops/rank.py:22-40) and then cum[j] +
// onehot(run_sym[j]) * (pos - run_start[j]) (:173-177). The kernels run
// UltraRank::rank6 and BucketRank<P>::rank6 of rank.cuh, the device
// functions that extend (fmd.cu), find_mems (mems.cu) and the dictionary's
// level (sparsedict.cu) instantiate, so holding these kernels against their
// plain versions holds the providers of those. An ultra query is one
// 32-byte row; a bucketed one two round trips through the run index (the
// bucket's 16-byte entry, then the run's record), each bound by load
// latency, so the design keeps one position a thread and launches enough
// threads to keep many loads in flight.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

template <class Rank, class P = typename Rank::Pos>
__global__ void rank6_kernel(Rank rk, const P* __restrict__ pos, int64_t n,
                             P* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  P r[6];
  rk.rank6(pgt::ld(pos + i), r);
#pragma unroll
  for (int c = 0; c < 6; ++c) out[6 * i + c] = r[c];
}

constexpr int kThreads = 256;

template <class Rank, class P = typename Rank::Pos>
int launch(const Rank& rk, const P* pos, int64_t n, P* out, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    rank6_kernel<Rank><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(rk, pos, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[i, :] = rank_table[clamp(pos[i], 0, n_rows - 1), 0:6], int32
int pgt_rank6_ultra(const int* rank_table, int64_t n_rows, const int* pos,
                    int64_t n, int* out, void* stream) {
  pgt::UltraRank rk{{}, reinterpret_cast<const int4*>(rank_table), n_rows};
  return launch(rk, pos, n, out, stream);
}

// out[i, :] = bucketed rank6(pos[i]) through the run index [n_buckets, 4]
// over buckets of 2^shift positions, run_rec [n_runs, 8] and run_start
// [n_runs] (rank.cuh:RunIndex), int32
int pgt_rank6_bucketed(const int* run_index, int64_t n_buckets, int shift,
                       const int* run_rec, const int* run_start, int64_t n_runs, const int* pos,
                       int64_t n, int* out, void* stream) {
  pgt::BucketRank<int> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, pos, n, out, stream);
}

// the same over int64 tables and positions
int pgt_rank6_bucketed64(const int* run_index, int64_t n_buckets, int shift,
                         const int64_t* run_rec, const int64_t* run_start, int64_t n_runs,
                         const int64_t* pos, int64_t n, int64_t* out,
                         void* stream) {
  pgt::BucketRank<int64_t> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, pos, n, out, stream);
}

}  // extern "C"
