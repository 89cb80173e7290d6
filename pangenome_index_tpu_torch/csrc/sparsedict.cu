// The long-seed dictionary's frontier level: every distinct length-t
// substring of the index (key, k, kp, size) extended to the left by each of
// the four bases, the children that occur often enough kept and compacted.
//
// Replaces ops/sparsedict.py:_level_step_device (and the chain of levels in
// _run_levels_device / build_sparse_dict_device), XLA programs on the TPU:
// a rank6 pair per entry, four children as whole [C, 8] states, a cumsum and
// a scatter per branch over a buffer of guessed capacity C, restarted at 4 C
// when a level overflowed, keys split into 30-bit halves to stay in int32.
// Here a level is three launches over exactly the entries it has:
//   expand   a thread an entry: one load of its rank rows (rank.cuh), the
//            four backward extensions from them (extend1: k' = occ + C[c],
//            kp' = kp + the advance of the reverse interval, size' = the
//            count inside), the children written branch-major into a scratch
//            [4, D] with size 0 where a child is dropped, and the block's
//            kept children counted per branch (ballot, popcount);
//   scan     one block turns the [4, blocks] counts, read branch-major as one
//            row, into exclusive offsets and the level's total: an offset is
//            at once the start of the branch and of the block inside it;
//   scatter  the blocks of expand again: a kept child's place is its
//            block's offset plus its rank among the block's kept children of
//            its branch (ballot, popcount, a prefix over the warps), where it
//            is written with key | base << 2t.
// Branch-major order with the source order kept inside a branch keeps the
// keys sorted with no sort, as in the host build. Keys are plain int64, so
// t up to 30 (s = 31) is exact. The wrapper reads the total between scan and
// scatter and allocates the next level at its exact size.
//
// What bounds it: bytes. A level must read an entry (20 bytes) and its one
// or two 64-byte rank rows, a dependent random gather, and write 20 bytes a
// kept child; the scratch between expand and scatter (48 bytes an entry
// written and read) is what this simple form adds to that. Both rank
// providers are instantiated: checkpoint rows or dense records.
#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int kBlock = 256;  // entries a block; ops/sparsedict.py:LEVEL_BLOCK
constexpr int kWarps = kBlock / 32;
constexpr int kScanThreads = 1024;

// code of base b (A, C, G, T -> 1, 2, 3, 5)
__device__ __forceinline__ int base_code(int b) { return b + 1 + (b == 3); }

template <class Rank>
__global__ void __launch_bounds__(kBlock)
sdict_expand_kernel(Rank rk, const int* __restrict__ Cg,
                    const int* __restrict__ vals, int64_t n_entries,
                    int thresh, int* __restrict__ child_sz,
                    int2* __restrict__ child_kkp, int* __restrict__ counts) {
  __shared__ int warp_kept[4][kWarps];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool live = i < n_entries;
  int k = 0, kp = 0, sz = 0;
  if (live) {
    k = __ldg(vals + 3 * i);
    kp = __ldg(vals + 3 * i + 1);
    sz = __ldg(vals + 3 * i + 2);
  }
  // a thread past the entries ranks the empty interval at 0 and keeps nothing
  const typename Rank::Rows rows = rk.load(k, sz);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int ck, ckp, cs;
    pgt::extend1(rk, rows, Cg, k, kp, sz, base_code(b), false, ck, ckp, cs);
    const bool keep = live && cs >= thresh;
    if (live) {
      child_sz[b * n_entries + i] = keep ? cs : 0;
      child_kkp[b * n_entries + i] = keep ? make_int2(ck, ckp) : make_int2(0, 0);
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if ((threadIdx.x & 31) == 0) warp_kept[b][threadIdx.x >> 5] = __popc(kept);
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_kept[threadIdx.x][w];
    counts[static_cast<int64_t>(threadIdx.x) * gridDim.x + blockIdx.x] = total;
  }
}

// counts [n] -> offsets [n] (exclusive prefix sums) and total[0] = their sum,
// by one block: tiles of kScanThreads values, a running carry between tiles.
// The sum is below 2^31: a level has no more entries than the index has rows.
__global__ void __launch_bounds__(kScanThreads)
sdict_scan_kernel(const int* __restrict__ counts, int64_t n,
                  int* __restrict__ offsets, int* __restrict__ total) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_s = 0;
  __syncthreads();
  for (int64_t base = 0; base < n; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int v = i < n ? counts[i] : 0;
    int incl = v;  // inclusive prefix inside the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive prefix over the warps' sums
      int ws = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, ws, d);
        if (lane >= d) ws += up;
      }
      warp_sum[lane] = ws;
    }
    __syncthreads();
    const int carry = carry_s;
    const int before = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - v;
    if (i < n) offsets[i] = before;
    __syncthreads();  // every thread has read the carry and the sums
    if (threadIdx.x == kScanThreads - 1) carry_s = before + v;
  }
  __syncthreads();
  if (threadIdx.x == 0) total[0] = carry_s;
}

__global__ void __launch_bounds__(kBlock)
sdict_scatter_kernel(const int64_t* __restrict__ keys,
                     const int* __restrict__ child_sz,
                     const int2* __restrict__ child_kkp,
                     const int* __restrict__ offsets, int64_t n_entries,
                     int level, int64_t* __restrict__ out_keys,
                     int* __restrict__ out_vals) {
  __shared__ int warp_kept[4][kWarps];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool live = i < n_entries;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cs[4], rank_in_warp[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    cs[b] = live ? __ldg(child_sz + b * n_entries + i) : 0;
    const unsigned kept = __ballot_sync(0xffffffffu, cs[b] != 0);
    rank_in_warp[b] = __popc(kept & ((1u << lane) - 1u));
    if (lane == 0) warp_kept[b][warp] = __popc(kept);
  }
  __syncthreads();
  const int64_t key = live ? keys[i] : 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (cs[b] == 0) continue;
    int before = rank_in_warp[b];
    for (int w = 0; w < warp; ++w) before += warp_kept[b][w];
    const int64_t dst =
        __ldg(offsets + static_cast<int64_t>(b) * gridDim.x + blockIdx.x) + before;
    const int2 kkp = __ldg(child_kkp + b * n_entries + i);
    out_keys[dst] = key | (static_cast<int64_t>(b) << (2 * level));
    out_vals[3 * dst] = kkp.x;
    out_vals[3 * dst + 1] = kkp.y;
    out_vals[3 * dst + 2] = cs[b];
  }
}

// expand, then the scan of its block counts; blocks must be
// ceil(n_entries / kBlock), the partition scatter walks again
template <class Rank>
int launch_expand(const Rank& rk, const int* C, const int* vals,
                  int64_t n_entries, int thresh, int64_t blocks, int* child_sz,
                  int* child_kkp, int* counts, int* offsets, int* total,
                  void* stream) {
  if (n_entries <= 0 || blocks != (n_entries + kBlock - 1) / kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sdict_expand_kernel<Rank><<<static_cast<unsigned>(blocks), kBlock, 0, st>>>(
      rk, C, vals, n_entries, thresh, child_sz,
      reinterpret_cast<int2*>(child_kkp), counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sdict_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, 4 * blocks, offsets,
                                                 total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vals [n_entries, 3] int32 (k, kp, size) -> child_sz [4, n_entries] int32
// (0 = dropped), child_kkp [4, n_entries, 2] int32, counts and offsets
// [4, blocks] int32, total [1] int32; checkpoint tables
int pgt_sdict_expand_ckpt(const int* ckpt, int64_t nrows, const int* C,
                          const int* vals, int64_t n_entries, int thresh,
                          int64_t blocks, int* child_sz, int* child_kkp,
                          int* counts, int* offsets, int* total,
                          void* stream) {
  pgt::CkptRank rk{ckpt, static_cast<int>(nrows - 1)};
  return launch_expand(rk, C, vals, n_entries, thresh, blocks, child_sz,
                       child_kkp, counts, offsets, total, stream);
}

// the same over dense tables
int pgt_sdict_expand_dense(const int* pos_to_run, int64_t n_p2r,
                           const int* rec, int64_t n_runs, const int* C,
                           const int* vals, int64_t n_entries, int thresh,
                           int64_t blocks, int* child_sz, int* child_kkp,
                           int* counts, int* offsets, int* total,
                           void* stream) {
  pgt::DenseRank rk{pos_to_run, n_p2r, reinterpret_cast<const int4*>(rec),
                    n_runs};
  return launch_expand(rk, C, vals, n_entries, thresh, blocks, child_sz,
                       child_kkp, counts, offsets, total, stream);
}

// keys [n_entries] int64 and expand's outputs -> the next level's out_keys
// [total] int64 and out_vals [total, 3] int32 (total: what scan reported)
int pgt_sdict_scatter(const int64_t* keys, const int* child_sz,
                      const int* child_kkp, const int* offsets,
                      int64_t n_entries, int64_t blocks, int level,
                      int64_t* out_keys, int* out_vals, void* stream) {
  if (n_entries <= 0 || blocks != (n_entries + kBlock - 1) / kBlock ||
      level < 0 || level > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  sdict_scatter_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      keys, child_sz, reinterpret_cast<const int2*>(child_kkp), offsets,
      n_entries, level, out_keys, out_vals);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
