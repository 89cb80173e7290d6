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
// a read are used; padding is staged with them and never looked at.
//
// What bounds it: each step's rank rows depend on the step before, so a
// read is a chain of load latencies (as in K3), and a lone warp's dependent
// instructions cost 4 to 5 cycles each. Nothing about a read's codes depends
// on the chain, so the design keeps everything but the rows off it:
//   - a block stages the codes of its reads in shared memory before it walks
//     them, coalesced and packed at 4 bits (codes outside 1..5 as 0, which
//     ends a read), a window of kWindow positions at a time; a thread then
//     reads eight codes with one shared-memory word;
//   - while a step's rows are in flight the thread takes the next step's
//     code and derives what depends on it alone (its complement, C[c] from
//     shared memory), so that when the range of the next step is known every
//     load of it is issued at once: the planes and the count pair of the
//     code, all of one 64-byte line (rank.cuh:load_lf). No load waits for
//     another load of its step;
//   - after the rows arrive a step is one equality mask, two popcounts and
//     the adds (rank.cuh:lf): the "less than" masks and the reverse
//     interval's advance, which backward search never uses, are not computed.
// The reads are independent: one launch, small blocks to spread the threads
// over every SM. The rank provider is a template parameter: checkpoint rows
// (int32 positions, or int64 over the two-level rows of n >= 2^31, whose
// superblock bases a block stages in shared memory) or dense records.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 64;         // reads a block
constexpr int kWindow = 256;         // read positions staged at a time
constexpr int kWords = kWindow / 8;  // packed words a read and window

template <class Rank, class P = typename Rank::Pos>
__global__ void __launch_bounds__(kThreads)
count_kernel(Rank rk, const P* __restrict__ Cg,
             const int* __restrict__ codes, int64_t width,
             const int* __restrict__ lengths, int64_t n_reads, P n,
             P* __restrict__ first_out, P* __restrict__ second_out) {
  // word j of the block's read r at [j * kThreads + r]: a warp's reads of
  // its own words fall into 32 banks
  __shared__ uint32_t packed[kWords * kThreads];
  __shared__ P c_of[8];
  rk.stage();
  const int tid = threadIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t b = b0 + tid;
  const int reads_here =
      static_cast<int>(n_reads - b0 < kThreads ? n_reads - b0 : kThreads);
  if (tid < 8) c_of[tid] = tid < 7 ? pgt::ld(Cg + tid) : 0;
  const int len = b < n_reads ? __ldg(lengths + b) : 0;
  P first = 0, second = n - 1;
  // no step is taken over a batch of width 0, whatever the lengths say (the
  // loop of ops/rank.py:count runs `width` times)
  bool done = len <= 0 || width <= 0;
  // a length past the padded width reads code 0 there, as JAX's one-hot
  // select does; an empty index matches nothing
  if (!done && (len > width || n <= 0)) {
    first = 1;
    second = 0;
    done = true;
  }
  int i = len - 1;  // the read position of the next step
  const int windows = static_cast<int>((width + kWindow - 1) / kWindow);
  for (int w = windows - 1; w >= 0; --w) {
    const int lo_pos = w * kWindow;
    // also the barrier between the last window's readers and this one's
    // writers; a window that no read of the block reaches is not staged
    if (!__syncthreads_or(!done && i >= lo_pos)) continue;
    const int64_t span = width - lo_pos;
    const int words_here =
        static_cast<int>(span < kWindow ? (span + 7) / 8 : kWords);
    for (int idx = tid; idx < reads_here * words_here; idx += kThreads) {
      const int r = idx / words_here, j = idx - r * words_here;
      const int64_t p0 = lo_pos + 8 * j;
      const int* src = codes + (b0 + r) * width + p0;
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = p0 + e < width ? __ldg(src + e) : 0;
        word |= (c >= 1 && c <= 5 ? static_cast<uint32_t>(c) : 0u) << (4 * e);
      }
      packed[j * kThreads + r] = word;
    }
    __syncthreads();
    if (done || i < lo_pos) continue;
    int at = i - lo_pos;  // position inside the window
    uint32_t word = packed[(at >> 3) * kThreads + tid];
    int c = (word >> (4 * (at & 7))) & 15;
    int qe = pgt::comp_code(c);
    P c_c = c_of[c];
    while (true) {
      if (c == 0) {
        first = 1;
        second = 0;
        done = true;
        break;
      }
      const P size = second + 1 - first;
      const typename Rank::LfRows rows = rk.load_lf(first, size, qe);
      // while the rows are in flight: the next step's code and what depends
      // on it alone
      int c_next = 0;
      if (at > 0) {
        if (((at - 1) & 7) == 7) word = packed[((at - 1) >> 3) * kThreads + tid];
        c_next = (word >> (4 * ((at - 1) & 7))) & 15;
      }
      const int qe_next = pgt::comp_code(c_next);
      const P cc_next = c_of[c_next];
      P lo, inside;
      rk.lf(rows, first, size, c, qe, lo, inside);
      if (inside <= 0) {
        first = 1;
        second = 0;
        done = true;
        break;
      }
      first = lo + c_c;
      second = first + inside - 1;
      --i;
      if (--at < 0) break;
      c = c_next;
      qe = qe_next;
      c_c = cc_next;
    }
    if (i < 0) done = true;
  }
  if (b < n_reads) {
    first_out[b] = first;
    second_out[b] = second;
  }
}

template <class Rank, class P = typename Rank::Pos>
int launch(const Rank& rk, const P* C, const int* codes, int64_t width,
           const int* lengths, int64_t n_reads, P n, P* first, P* second,
           void* stream) {
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
  pgt::CkptRank<int> rk{ckpt, static_cast<int>(nrows - 1)};
  return launch(rk, C, codes, width, lengths, n_reads, n, first, second,
                stream);
}

// int64 positions over two-level rows (super_S [n_super, 8] int64)
int pgt_count_ckpt64(const int* ckpt, int64_t nrows, const int64_t* super_S,
                     int64_t n_super, int super_shift, const int64_t* C,
                     const int* codes, int64_t width, const int* lengths,
                     int64_t n_reads, int64_t n, int64_t* first,
                     int64_t* second, void* stream) {
  pgt::CkptRank<int64_t> rk;
  if (!pgt::make_ckpt64(ckpt, nrows, super_S, n_super, super_shift, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, codes, width, lengths, n_reads, n, first, second,
                stream);
}

// dense tables: the lines [n_lines, 4] int32 (rank.cuh:DenseRank), rec
// [n_runs, 8] int32
int pgt_count_dense(const int* lines, int64_t n_lines, const int* rec,
                    int64_t n_runs, const int* C, const int* codes,
                    int64_t width, const int* lengths, int64_t n_reads, int n,
                    int* first, int* second, void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch(rk, C, codes, width, lengths, n_reads, n, first, second,
                stream);
}

// the same over int64 positions: rec [n_runs, 8] int64
int pgt_count_dense64(const int* lines, int64_t n_lines, const int64_t* rec,
                      int64_t n_runs, const int64_t* C, const int* codes,
                      int64_t width, const int* lengths, int64_t n_reads,
                      int64_t n, int64_t* first, int64_t* second, void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch(rk, C, codes, width, lengths, n_reads, n, first, second,
                stream);
}

}  // extern "C"
