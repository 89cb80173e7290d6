// K1: dense-mode rank and row gathers.
//
// Replaces ops/pallas_rank.py:gather_rows_pallas (the Pallas scalar-prefetch
// gather, pallas_rank.py:39) and its caller rank6_pallas (pallas_rank.py:70).
// On the TPU the gather moved aligned 8-row windows by DMA because a grid
// step could only fetch whole blocks; here every row is copied on its own,
// so the alignment and the 8x over-fetch are gone and any batch size is
// taken. rank6_pallas read the run id from pos_to_run (4 bytes a position,
// 8 at int64: 80 MB on a 20 Mbp index, past L2) and then the record; here
// rank6_dense reads the position's 16-byte line instead (ops/tables.py:
// derive_dense_lines, 5 MB there, which stays in L2), then the record: one
// load that hits L2 and one that misses, a position a thread.
//
// gather_rows is a copy stream when the indices are in order (the dense
// table check gathers every record), so it is laid out to move at the
// memory rate: rows of 8 words (the int32 records) and of 16 (the int64
// records viewed as int32 words) are copied a 16-byte vector a thread,
// consecutive threads on consecutive vectors of the output, so that both
// the loads of a row and the stores coalesce. The
// row and the vector within it come from the thread index by shifts (no
// 64-bit division), and one lane of each row loads its index and passes it
// to the row's other lanes by a warp shuffle (one index load a row). Other
// widths (3: the seed table's rows) take a scalar path, a word a thread,
// with 32-bit index math where the output has fewer than 2^31 words.
//
// rank6_dense runs pgt::DenseRank<P>::rank6 from rank.cuh, the same device
// function K2 (fmd.cu), K3 (mems.cu), K7 (count.cu) and the levels
// (sparsedict.cu, mertable.cu) instantiate for dense tables, so holding this
// kernel against its plain version holds theirs.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 256;

// out[i, :] = rec[clamp(idx[i]), :] for rows of 4 << kLog words, a 16-byte
// vector a thread: vector v of the output is vector v & (2^kLog - 1) of row
// v >> kLog. The 2^kLog lanes of a row are consecutive lanes of one warp.
template <int kLog>
__global__ void __launch_bounds__(kThreads)
gather_rows_vec(const int4* __restrict__ rec, int64_t n_rows,
                const int* __restrict__ idx, int64_t n_out,
                int4* __restrict__ out) {
  constexpr int kVec = 1 << kLog;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = v >> kLog;
  const int lane = threadIdx.x & 31, col = lane & (kVec - 1);
  int j = 0;
  if (col == 0 && row < n_out) j = __ldg(idx + row);
  j = __shfl_sync(0xffffffffu, j, lane - col);  // every lane of the warp takes part
  if (row >= n_out) return;
  const int64_t r = pgt::clamp64(j, 0, n_rows - 1);
  out[v] = __ldg(rec + (r << kLog) + col);
}

// The same for any width, a word a thread (I: the index type of the
// output's words, int where they number fewer than 2^31)
template <class I>
__global__ void __launch_bounds__(kThreads)
gather_rows_word(const int* __restrict__ rec, int64_t n_rows, int width,
                 const int* __restrict__ idx, I total, int* __restrict__ out) {
  const I e = static_cast<I>(blockIdx.x) * kThreads + static_cast<I>(threadIdx.x);
  if (e >= total) return;
  const I row = e / static_cast<I>(width);
  const I col = e - row * static_cast<I>(width);
  const int64_t r = pgt::clamp64(__ldg(idx + row), 0, n_rows - 1);
  out[e] = __ldg(rec + r * width + col);
}

template <class P>
__global__ void rank6_dense_kernel(pgt::DenseRank<P> rk,
                                   const P* __restrict__ pos, int64_t n,
                                   P* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  P r[6];
  rk.rank6(pgt::ld(pos + i), r);
#pragma unroll
  for (int c = 0; c < 6; ++c) out[6 * i + c] = r[c];
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <class P>
int rank6_dense(const int* lines, int64_t n_lines, const P* rec, int64_t n_runs,
                const P* pos, int64_t n, P* out, void* stream) {
  if (n > 0) {
    rank6_dense_kernel<P><<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        pgt::make_dense(lines, n_lines, rec, n_runs), pos, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* pgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[i, :] = rec[clamp(idx[i], 0, n_rows - 1), :] for int32 rows of
// `width` words (n_rows >= 1 where n_out > 0)
int pgt_gather_rows(const int* rec, int64_t n_rows, int width, const int* idx,
                    int64_t n_out, int* out, void* stream) {
  if (width < 1 || n_out < 0 || (n_out > 0 && n_rows < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_out * width;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(rec) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int4* rv = reinterpret_cast<const int4*>(rec);
  int4* ov = reinterpret_cast<int4*>(out);
  if (aligned && width == 8) {
    gather_rows_vec<1><<<blocks_for(total / 4), kThreads, 0, st>>>(rv, n_rows, idx,
                                                                   n_out, ov);
  } else if (aligned && width == 16) {
    gather_rows_vec<2><<<blocks_for(total / 4), kThreads, 0, st>>>(rv, n_rows, idx,
                                                                   n_out, ov);
  } else if (total < (int64_t{1} << 31) - kThreads) {
    gather_rows_word<int><<<blocks_for(total), kThreads, 0, st>>>(
        rec, n_rows, width, idx, static_cast<int>(total), out);
  } else {
    gather_rows_word<int64_t><<<blocks_for(total), kThreads, 0, st>>>(
        rec, n_rows, width, idx, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[i, :] = dense rank6(pos[i]) through the lines [n_lines, 4] int32 and
// rec [n_runs, 8] (rank.cuh:DenseRank): int32 positions, records and ranks
int pgt_rank6_dense(const int* lines, int64_t n_lines, const int* rec,
                    int64_t n_runs, const int* pos, int64_t n, int* out,
                    void* stream) {
  return rank6_dense(lines, n_lines, rec, n_runs, pos, n, out, stream);
}

// the same at int64 positions, records and ranks
int pgt_rank6_dense64(const int* lines, int64_t n_lines, const int64_t* rec,
                      int64_t n_runs, const int64_t* pos, int64_t n, int64_t* out,
                      void* stream) {
  return rank6_dense(lines, n_lines, rec, n_runs, pos, n, out, stream);
}

}  // extern "C"
