// K1: dense-mode rank and row gathers.
//
// Replaces ops/pallas_rank.py:gather_rows_pallas (the Pallas scalar-prefetch
// gather, pallas_rank.py:39) and its caller rank6_pallas (pallas_rank.py:70).
// On the TPU the gather moved aligned 8-row windows by DMA because a grid
// step could only fetch whole blocks; here every thread loads exactly the
// row it needs, so the alignment and the 8x over-fetch are gone and any
// batch size is taken. gather_rows is a single random load per row element
// (neighbouring threads read neighbouring words of a row, so the stores
// coalesce). rank6_pallas read the run id from pos_to_run (4 bytes a
// position: 80 MB on a 20 Mbp index, past L2) and then the record; here
// rank6_dense reads the position's 16-byte line instead (ops/tables.py:
// derive_dense_lines, 5 MB there, which stays in L2), then the record: one
// load that hits L2 and one that misses, a position a thread.
//
// rank6_dense runs pgt::DenseRank::rank6 from rank.cuh, the same device
// function K2 (fmd.cu), K3 (mems.cu), K7 (count.cu) and the levels
// (sparsedict.cu, mertable.cu) instantiate for dense tables, so holding this
// kernel against its plain version holds theirs.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

__global__ void gather_rows_kernel(const int* __restrict__ rec, int64_t n_rows,
                                   int width, const int* __restrict__ idx,
                                   int64_t n_out, int* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_out * width) return;
  const int64_t row = e / width;
  const int col = static_cast<int>(e - row * width);
  const int64_t j = pgt::clamp64(__ldg(idx + row), 0, n_rows - 1);
  out[e] = __ldg(rec + j * width + col);
}

__global__ void rank6_dense_kernel(pgt::DenseRank rk,
                                   const int* __restrict__ pos, int64_t n,
                                   int* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int r[6];
  rk.rank6(__ldg(pos + i), r);
#pragma unroll
  for (int c = 0; c < 6; ++c) out[6 * i + c] = r[c];
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* pgt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[i, :] = rec[clamp(idx[i], 0, n_rows - 1), :] for int32 rows of `width`
int pgt_gather_rows(const int* rec, int64_t n_rows, int width, const int* idx,
                    int64_t n_out, int* out, void* stream) {
  const int64_t total = n_out * width;
  if (total > 0) {
    gather_rows_kernel<<<blocks_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rec, n_rows, width, idx, n_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[i, :] = dense rank6(pos[i]) through the lines [n_lines, 4] int32 and
// rec [n_runs, 8] int32 (rank.cuh:DenseRank)
int pgt_rank6_dense(const int* lines, int64_t n_lines, const int* rec,
                    int64_t n_runs, const int* pos, int64_t n, int* out,
                    void* stream) {
  if (n > 0) {
    pgt::DenseRank rk{{}, reinterpret_cast<const int4*>(lines), n_lines,
                      reinterpret_cast<const int4*>(rec), n_runs};
    rank6_dense_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(rk, pos, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
