// K7: batched backward search (count), one thread per read.
//
// Replaces ops/rank.py:count, an XLA program on the TPU: a fori_loop over
// the longest read, every lane taking one lf_range step per iteration (a
// one-hot select-sum to read its code, two rank queries), so every read paid
// for the longest one. Here each thread walks its own read right to left
// (count_encoded, r-index.hpp:550-556) from (first, second) = (0, n - 1):
// per code c, lo = rank(first, c), inside = rank(second + 1, c) - lo, then
// first = lo + C[c], second = first + inside - 1. A code <= 0 or an empty
// range gives the reference's (1, 0) sentinel; it is absorbing (lf_range
// keeps it), so the thread stops there. Only the first lengths[b] codes of
// a read are looked at; padding is never read.
//
// What bounds it: each step is two rank6 row loads that depend on the
// previous step, so a read is a chain of load latencies, as in K3. The rows
// of a step are issued together with the load of the step's code (their
// addresses need only the range), so a step waits for one round trip, not
// two; only the counts of the step's own code are computed (rank.cuh), and
// the reads are independent, so the whole batch is one launch with small
// blocks to spread the threads over every SM. The rank provider is a
// template parameter: checkpoint rows or dense records.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

template <class Rank>
__global__ void count_kernel(Rank rk, const int* __restrict__ Cg,
                             const int* __restrict__ codes, int64_t width,
                             const int* __restrict__ lengths, int64_t n_reads,
                             int n, int* __restrict__ first_out,
                             int* __restrict__ second_out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_reads) return;
  const int* read = codes + b * width;
  int first = 0, second = n - 1;
  for (int i = __ldg(lengths + b) - 1; i >= 0; --i) {
    // the range's rank rows, in flight while the code arrives
    const typename Rank::Rows rows = rk.load(first, second + 1 - first);
    // a length past the padded width reads code 0 there, as JAX's one-hot
    // select does
    const int c = i < width ? __ldg(read + i) : 0;
    if (c <= 0 || c > 5 || first > second) {
      first = 1;
      second = 0;
      break;
    }
    const int c_c = __ldg(Cg + c);
    int lo, inside, unused;
    rk.counts(rows, first, second + 1 - first, c, pgt::comp_code(c), lo,
              inside, unused);
    if (inside <= 0) {
      first = 1;
      second = 0;
      break;
    }
    first = lo + c_c;
    second = first + inside - 1;
  }
  first_out[b] = first;
  second_out[b] = second;
}

constexpr int kThreads = 64;

template <class Rank>
int launch(const Rank& rk, const int* C, const int* codes, int64_t width,
           const int* lengths, int64_t n_reads, int n, int* first,
           int* second, void* stream) {
  if (n_reads > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n_reads + kThreads - 1) / kThreads);
    count_kernel<Rank><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        rk, C, codes, width, lengths, n_reads, n, first, second);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes [n_reads, width] int32 (right-padded), lengths [n_reads] int32;
// checkpoint tables: ckpt [nrows, 16] int32 bit-plane rows
int pgt_count_ckpt(const int* ckpt, int64_t nrows, const int* C,
                   const int* codes, int64_t width, const int* lengths,
                   int64_t n_reads, int n, int* first, int* second,
                   void* stream) {
  pgt::CkptRank rk{ckpt, static_cast<int>(nrows - 1)};
  return launch(rk, C, codes, width, lengths, n_reads, n, first, second,
                stream);
}

// dense tables: pos_to_run [n_p2r] int32, rec [n_runs, 8] int32
int pgt_count_dense(const int* pos_to_run, int64_t n_p2r, const int* rec,
                    int64_t n_runs, const int* C, const int* codes,
                    int64_t width, const int* lengths, int64_t n_reads, int n,
                    int* first, int* second, void* stream) {
  pgt::DenseRank rk{pos_to_run, n_p2r, reinterpret_cast<const int4*>(rec),
                    n_runs};
  return launch(rk, C, codes, width, lengths, n_reads, n, first, second,
                stream);
}

}  // extern "C"
