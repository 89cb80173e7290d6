// K3: MEM finding, the whole per-read state machine in one launch, one
// thread per read.
//
// Replaces ops/mems.py:find_mems_impl, which on the TPU ran thousands of reads
// in lockstep lanes of a lax.while_loop: one extension for every lane per
// iteration, with one-hot selects for every per-lane table read and the
// emission buffers rewritten each iteration. Here each thread walks its own
// read through the same transitions (phases 0..5 of mems.py, the three steps
// of algorithm.hpp:653-757) with the loop state in registers; a finished read
// costs nothing, and the MEM buffers are written once per emitted MEM.
//
// What bounds it: every extension is two dependent-on-the-last-step random
// row loads (rank.cuh), so a read is a chain of load latencies, and the card
// is kept busy only by having many reads in flight. The design therefore
// (a) issues both rank rows of a step together, (b) keeps the read's codes
// and seed rows as plain per-thread loads that stay in L1, and (c) relies on
// the caller sorting reads by seed difficulty (ops/mertable.py:
// seed_difficulty), so the 32 reads of a warp have like work and the warp
// does not idle behind one hard read. The whole sorted batch is one launch.
//
// Seeds arrive pre-resolved per read position as int4 (k, kp, s, len), len 0
// meaning no usable seed (mems.py:87-116, done by the wrapper). Outputs:
// (start << 16) | end, bwt_start and size per slot [B, M] (zero past the
// count), the exact MEM count per read (it may exceed M), and optionally the
// number of extension steps each read took.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

template <class Rank>
__global__ void find_mems_kernel(Rank rk, const int* __restrict__ Cg,
                                 const int8_t* __restrict__ codes,
                                 const int* __restrict__ lengths,
                                 const int4* __restrict__ seeds, int n_reads,
                                 int width, int min_len, int min_occ, int N,
                                 int M, int64_t max_iters,
                                 int* __restrict__ m_se,
                                 int* __restrict__ m_bwt,
                                 int* __restrict__ m_size,
                                 int* __restrict__ count,
                                 int* __restrict__ steps_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_reads) return;
  int C[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) C[c] = __ldg(Cg + c);
  const int L = width - 1;  // codes are padded with the NUL column j == L
  const int8_t* cr = codes + static_cast<int64_t>(b) * width;
  const int4* sr = seeds ? seeds + static_cast<int64_t>(b) * width : nullptr;
  const int len = __ldg(lengths + b);
  int* se_out = m_se + static_cast<int64_t>(b) * M;
  int* bwt_out = m_bwt + static_cast<int64_t>(b) * M;
  int* size_out = m_size + static_cast<int64_t>(b) * M;
  for (int i = 0; i < M; ++i) {
    se_out[i] = 0;
    bwt_out[i] = 0;
    size_out[i] = 0;
  }

  int phase = 0, x = 0, j = 0, k = 0, kp = 0, s = 0;
  int k2 = 0, kp2 = 0, s2 = 0, cnt = 0, steps = 0;
  for (int64_t it = 0; it < max_iters && phase != 4; ++it) {
    // --- phase 0: begin a find_mems_function call at x; phase 5: step 3 ---
    const bool enter1 = phase == 0 && !(x >= len || len - x < min_len);
    const bool enter3 = phase == 5;
    if (phase == 0) phase = enter1 ? 1 : 4;
    if (enter3) phase = 3;
    if (enter1) {
      j = x + min_len - 1;
      k = 0;
      kp = 0;
      s = N;
    }
    if (sr != nullptr && (enter1 || enter3)) {
      // longest passing seed tier (pre-resolved): skips row.w extensions
      const int widx = enter1 ? x + min_len - 1 : j;
      const int4 row = sr[pgt::clamp64(widx, 0, L)];
      const bool okrow = row.z >= min_occ && row.z > 0 && row.w > 0;
      const bool can1 = enter1 && min_len > row.w && okrow;
      const bool can3 = enter3 && j - row.w > x && okrow;
      if (can1) j = x + min_len - 1 - row.w;
      if (can3) j = j - row.w;
      if (can1 || can3) {
        k = row.x;
        kp = row.y;
        s = row.z;
      }
    }
    if (phase == 4) break;

    // --- one extension step (phase 1, 2 or 3) ---
    const bool p1 = phase == 1, p2 = phase == 2, p3 = phase == 3;
    const int c = cr[pgt::clamp64(j, 0, L)];
    int nk, nkp, ns;
    pgt::extend1(rk, C, k, kp, s, c, p2, nk, nkp, ns);
    ++steps;
    const bool fail = ns < min_occ || ns <= 0;

    // --- transitions (mems.py:213-281) ---
    const bool p1_fail = p1 && fail, p1_ok = p1 && !fail;
    const bool p1_boundary = p1_ok && (j == x || j == 0);
    const bool p1_cont = p1_ok && !p1_boundary;
    const int e1 = x + min_len;
    const bool p1_to3 = p1_boundary && e1 >= len;
    const bool p1_to2 = p1_boundary && !(e1 >= len);
    const bool p2_fail = p2 && fail, p2_ok = p2 && !fail;
    const bool p2_to3 = p2_ok && j + 1 >= len;
    const bool p2_cont = p2_ok && !p2_to3;
    const bool p3_fail = p3 && fail, p3_ok = p3 && !fail;
    const bool p3_done = p3_ok && j - 1 == x;
    const bool p3_cont = p3_ok && !p3_done;

    // bint2 bookkeeping (algorithm.hpp:684-699)
    if (p1_boundary || p2_ok) {
      k2 = nk;
      kp2 = nkp;
      s2 = ns;
    }
    const bool emit = p1_to3 || p2_fail || p2_to3;
    if (emit) {
      const int e_val = p1_to3 ? e1 : (p2_fail ? j : len);
      if (cnt < M) {
        se_out[cnt] = static_cast<int>((static_cast<unsigned>(x) << 16) |
                                       static_cast<unsigned>(e_val));
        bwt_out[cnt] = k2;
        size_out[cnt] = s2;
      }
      ++cnt;
    }

    const int new_x = (p1_fail || p3_fail) ? j + 1 : (p3_done ? x + 1 : x);
    if (p1_fail || p3_fail || p3_done) phase = 0;
    if (p1_to2) phase = 2;
    if (emit) phase = 5;
    if (p1_cont || p3_cont) j = j - 1;
    if (p1_to2 || p1_to3) j = e1;
    if (p2_cont) j = j + 1;
    if (p2_to3) j = len;
    if (p1_cont || p1_to2 || p2_cont || p3_cont) {
      k = nk;
      kp = nkp;
      s = ns;
    }
    if (emit) {  // step 3 restarts from the full interval
      k = 0;
      kp = 0;
      s = N;
    }
    x = new_x;
  }
  count[b] = cnt;
  if (steps_out != nullptr) steps_out[b] = steps;
}

constexpr int kThreads = 64;

template <class Rank>
int launch(const Rank& rk, const int* C, const int8_t* codes,
           const int* lengths, const int4* seeds, int n_reads, int width,
           int min_len, int min_occ, int N, int M, int64_t max_iters,
           int* m_se, int* m_bwt, int* m_size, int* count, int* steps,
           void* stream) {
  if (n_reads > 0) {
    const unsigned blocks = (n_reads + kThreads - 1) / kThreads;
    find_mems_kernel<Rank><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        rk, C, codes, lengths, seeds, n_reads, width, min_len, min_occ, N, M,
        max_iters, m_se, m_bwt, m_size, count, steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pgt_find_mems_ckpt(const int* ckpt, int64_t nrows, const int* C,
                       const int8_t* codes, const int* lengths,
                       const int* seeds, int n_reads, int width, int min_len,
                       int min_occ, int N, int M, int64_t max_iters, int* m_se,
                       int* m_bwt, int* m_size, int* count, int* steps,
                       void* stream) {
  pgt::CkptRank rk{reinterpret_cast<const int4*>(ckpt), nrows};
  return launch(rk, C, codes, lengths, reinterpret_cast<const int4*>(seeds),
                n_reads, width, min_len, min_occ, N, M, max_iters, m_se, m_bwt,
                m_size, count, steps, stream);
}

int pgt_find_mems_dense(const int* pos_to_run, int64_t n_p2r, const int* rec,
                        int64_t n_runs, const int* C, const int8_t* codes,
                        const int* lengths, const int* seeds, int n_reads,
                        int width, int min_len, int min_occ, int N, int M,
                        int64_t max_iters, int* m_se, int* m_bwt, int* m_size,
                        int* count, int* steps, void* stream) {
  pgt::DenseRank rk{pos_to_run, n_p2r, reinterpret_cast<const int4*>(rec),
                    n_runs};
  return launch(rk, C, codes, lengths, reinterpret_cast<const int4*>(seeds),
                n_reads, width, min_len, min_occ, N, M, max_iters, m_se, m_bwt,
                m_size, count, steps, stream);
}

}  // extern "C"
