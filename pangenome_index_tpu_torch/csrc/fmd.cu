// K2: batched bidirectional FMD extension, one interval per thread.
//
// Replaces ops/fmd.py:extend (with ops/rank.py:_ckpt_rank6 as its rank
// step), an XLA program on the TPU whose one-hot selects and fused double
// rank batch were shaped by the TPU's gather issue rate. Each extension is
// two independent rank6 queries (at k and k+s), i.e. two random row loads,
// so the kernel is bound by load latency and by how many loads are in
// flight. The design issues both rows' loads before any arithmetic and
// computes only the three counts an extension uses (rank.cuh: on checkpoint
// tables two masks and four 64-bit popcounts over bit-plane rows, in place
// of the one-hot matrix math). The rank provider is a template parameter:
// bit-plane checkpoint rows, int32 or int64 positions (the two-level rows of
// n >= 2^31), dense records, ultra rows, or bucketed runs at int32 or int64
// positions (rank.cuh).
//
// Used one level at a time to build the m-mer seed table (ops/mertable.py),
// where a level is up to 4^m lanes, so every thread index is 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

template <class Rank, class P = typename Rank::Pos>
__global__ void extend_kernel(Rank rk, const P* __restrict__ Cg,
                              const P* __restrict__ k, const P* __restrict__ kp,
                              const P* __restrict__ s,
                              const int* __restrict__ code,
                              const uint8_t* __restrict__ forward, int64_t n,
                              P* __restrict__ ok, P* __restrict__ okp,
                              P* __restrict__ os) {
  rk.stage();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool fwd = forward != nullptr && forward[i] != 0;
  const P ki = pgt::ld(k + i), kpi = pgt::ld(kp + i), si = pgt::ld(s + i);
  P a, b, z;
  pgt::extend1(rk, rk.load(fwd ? kpi : ki, si), Cg, ki, kpi, si,
               __ldg(code + i), fwd, a, b, z);
  ok[i] = a;
  okp[i] = b;
  os[i] = z;
}

constexpr int kThreads = 256;

template <class Rank, class P = typename Rank::Pos>
int launch(const Rank& rk, const P* C, const P* k, const P* kp, const P* s,
           const int* code, const uint8_t* forward, int64_t n, P* ok, P* okp,
           P* os, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    extend_kernel<Rank><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        rk, C, k, kp, s, code, forward, n, ok, okp, os);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// checkpoint tables: ckpt [nrows, 16] int32 bit-plane rows
// (ops/tables.py:derive_rank_planes); forward may be null (all backward)
int pgt_extend_ckpt(const int* ckpt, int64_t nrows, const int* C, const int* k,
                    const int* kp, const int* s, const int* code,
                    const uint8_t* forward, int64_t n, int* ok, int* okp,
                    int* os, void* stream) {
  pgt::CkptRank<int> rk{ckpt, static_cast<int>(nrows - 1)};
  return launch(rk, C, k, kp, s, code, forward, n, ok, okp, os, stream);
}

// the same over int64 positions: two-level rows with their superblock
// bases super_S [n_super, 8] int64 (ops/tables.py:derive_super_S)
int pgt_extend_ckpt64(const int* ckpt, int64_t nrows, const int64_t* super_S,
                      int64_t n_super, int super_shift, const int64_t* C,
                      const int64_t* k, const int64_t* kp, const int64_t* s,
                      const int* code, const uint8_t* forward, int64_t n,
                      int64_t* ok, int64_t* okp, int64_t* os, void* stream) {
  pgt::CkptRank<int64_t> rk;
  if (!pgt::make_ckpt64(ckpt, nrows, super_S, n_super, super_shift, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, k, kp, s, code, forward, n, ok, okp, os, stream);
}

// dense tables: the lines [n_lines, 4] int32 (rank.cuh:DenseRank), rec
// [n_runs, 8] int32
int pgt_extend_dense(const int* lines, int64_t n_lines, const int* rec,
                     int64_t n_runs, const int* C, const int* k, const int* kp,
                     const int* s, const int* code, const uint8_t* forward,
                     int64_t n, int* ok, int* okp, int* os, void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch(rk, C, k, kp, s, code, forward, n, ok, okp, os, stream);
}

// the same over int64 positions: rec [n_runs, 8] int64
int pgt_extend_dense64(const int* lines, int64_t n_lines, const int64_t* rec,
                       int64_t n_runs, const int64_t* C, const int64_t* k,
                       const int64_t* kp, const int64_t* s, const int* code,
                       const uint8_t* forward, int64_t n, int64_t* ok,
                       int64_t* okp, int64_t* os, void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch(rk, C, k, kp, s, code, forward, n, ok, okp, os, stream);
}

// ultra rows: rank_table [n_rows, 8] int32
int pgt_extend_ultra(const int* rank_table, int64_t n_rows, const int* C,
                     const int* k, const int* kp, const int* s, const int* code,
                     const uint8_t* forward, int64_t n, int* ok, int* okp,
                     int* os, void* stream) {
  pgt::UltraRank rk{{}, reinterpret_cast<const int4*>(rank_table), n_rows};
  return launch(rk, C, k, kp, s, code, forward, n, ok, okp, os, stream);
}

// bucketed runs: the run index [n_buckets, 4] int32 over buckets of
// 2^shift positions, run_rec [n_runs, 8], run_start [n_runs]
// (rank.cuh:RunIndex); int32 positions
int pgt_extend_bucketed(const int* run_index, int64_t n_buckets, int shift,
                        const int* run_rec, const int* run_start, int64_t n_runs, const int* C,
                        const int* k, const int* kp, const int* s,
                        const int* code, const uint8_t* forward, int64_t n,
                        int* ok, int* okp, int* os, void* stream) {
  pgt::BucketRank<int> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, k, kp, s, code, forward, n, ok, okp, os, stream);
}

// the same over int64 positions
int pgt_extend_bucketed64(const int* run_index, int64_t n_buckets, int shift,
                          const int64_t* run_rec, const int64_t* run_start, int64_t n_runs, const int64_t* C,
                          const int64_t* k, const int64_t* kp,
                          const int64_t* s, const int* code,
                          const uint8_t* forward, int64_t n, int64_t* ok,
                          int64_t* okp, int64_t* os, void* stream) {
  pgt::BucketRank<int64_t> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, k, kp, s, code, forward, n, ok, okp, os, stream);
}

}  // extern "C"
