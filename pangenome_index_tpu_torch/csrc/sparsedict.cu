// The long-seed dictionary's frontier level: every distinct length-t
// substring of the index (key, k, kp, size) extended to the left by each of
// the four bases, the children that occur often enough kept and compacted.
//
// Replaces ops/sparsedict.py:_level_step_device (and the chain of levels in
// _run_levels_device / build_sparse_dict_device), XLA programs on the TPU:
// a rank6 pair per entry, four children as whole [C, 8] states, a cumsum and
// a scatter per branch over a buffer of guessed capacity C, restarted at 4 C
// when a level overflowed, keys split into 30-bit halves to stay in int32.
//
// Here a level is one launch over exactly the entries it has, a thread an
// entry, in blocks of kBlock that take their place in entry order from a
// ticket (so that every block before a block has started):
//   - the entry (8 bytes of key, 12 of k, kp, size) and its one or two rank
//     rows are loaded once, and the four backward extensions are taken from
//     them; a checkpoint row is loaded whole (four 16-byte loads: the planes
//     and every base's count pair), so the four bases read their pairs from
//     registers, and the other providers (dense records, ultra rows,
//     bucketed runs) go through rank.cuh's extend1;
//   - the block counts its kept children per branch (ballot, popcount; one
//     warp a branch scans the block's eight warp counts);
//   - the same four warps find the block's offset inside each branch by a
//     decoupled look-back (Merrill and Garland, "Single-pass Parallel
//     Prefix Scan with Decoupled Look-back", 2016): a block publishes its
//     count, then sums its predecessors' counts 32 at a time until it meets
//     one that has published its inclusive prefix, and publishes its own;
//   - each thread stores its kept children, the dropped ones go nowhere,
//     into the branch's own region of the output, where a warp's children
//     of a branch form one contiguous run: region b holds the children of
//     branch b, at most one an entry, so a region of D rows is an exact
//     bound and not a guess. (Staging a block's children in shared memory
//     to store each branch's as one run was slower, PERF.md.)
// The next level reads the four regions, in order, as one input (Segments);
// the wrapper reads the four totals after the launch and packs the last
// level once into contiguous keys / vals. Branch-major order with the source
// order kept inside a branch keeps the keys sorted with no sort, as in the
// host build. Keys are plain int64, so t up to 30 (s = 31) is exact. The
// entries' (k, kp, size) are int32 below n = 2^31 and int64 past it (an
// entry is then 32 bytes, not 20), over the two-level checkpoint rows whose
// superblock bases a block stages in shared memory, or over bucketed runs
// (rank.cuh).
//
// What bounds it: the bytes of a level are an entry and its rank rows (a
// gather, but in key order, which is k order, so the rows come nearly in
// sequence and the 20 MB table of the bench index stays in L2) and 20 bytes
// a kept child; nothing else touches device memory but 32 bytes of look-back
// state a block. What holds it back (PERF.md): a block's look-back walks
// over the blocks resident beside it, which all reach it at once.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int kBlock = 256;  // entries a block; ops/sparsedict.py:LEVEL_BLOCK
constexpr int kWarps = kBlock / 32;
// look-back state of a (branch, block): flag in the high word, value low
constexpr unsigned long long kAggregate = 1ull << 32;  // the block's count
constexpr unsigned long long kPrefix = 2ull << 32;     // count of all up to it

// The level's input: regions of `stride` rows, region r holding
// start[r + 1] - start[r] entries at its front; start[4] = D (the regions
// past the input's are empty).
struct Segments {
  int64_t start[5];
  int64_t stride;
};

// row of entry i of the level in the input regions (selects, so that the
// struct stays in parameter space)
__device__ __forceinline__ int64_t source_of(const Segments& sg, int64_t i) {
  int64_t row = i;
  if (i >= sg.start[1]) row = sg.stride + (i - sg.start[1]);
  if (i >= sg.start[2]) row = 2 * sg.stride + (i - sg.start[2]);
  if (i >= sg.start[3]) row = 3 * sg.stride + (i - sg.start[3]);
  return row;
}

// code of base b (A, C, G, T -> 1, 2, 3, 5)
__device__ __forceinline__ int base_code(int b) { return b + 1 + (b == 3); }

__device__ __forceinline__ unsigned long long load_state(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The rows an entry's four extensions read: the provider's own, or for
// checkpoint rows both whole rows in registers.
template <class Rank>
struct EntryRows {
  typename Rank::Rows r;
};

template <class P>
struct EntryRows<pgt::CkptRank<P>> {
  P row1, row2;
  int4 r1[4], r2[4];
};

template <class Rank>
constexpr bool kIsCkpt = pgt::IsCkptRank<Rank>::value;

template <class Rank, class P = typename Rank::Pos>
__device__ __forceinline__ EntryRows<Rank> load_rows(const Rank& rk, P k, P s) {
  if constexpr (kIsCkpt<Rank>) {
    EntryRows<Rank> e;
    e.row1 = rk.row_of(k);
    e.row2 = rk.row_of(k + s);
    const int4* p1 = reinterpret_cast<const int4*>(rk.row_ptr(e.row1));
    const int4* p2 = reinterpret_cast<const int4*>(rk.row_ptr(e.row2));
#pragma unroll
    for (int q = 0; q < 4; ++q) e.r1[q] = __ldg(p1 + q);
#pragma unroll
    for (int q = 0; q < 4; ++q) e.r2[q] = e.row2 != e.row1 ? __ldg(p2 + q) : e.r1[q];
    return e;
  } else {
    return EntryRows<Rank>{rk.load(k, s)};
  }
}

// the count pair (S[qe], S[qe + 1]) of qe in 1..5 of a whole checkpoint row
__device__ __forceinline__ int2 pair_in(const int4 (&r)[4], int qe) {
  switch (qe) {
    case 1: return make_int2(r[1].z, r[1].w);
    case 2: return make_int2(r[2].x, r[2].y);
    case 3: return make_int2(r[2].z, r[2].w);
    case 4: return make_int2(r[3].x, r[3].y);
    default: return make_int2(r[3].z, r[3].w);
  }
}

// The backward extension of (k, kp, s) by base b, as pgt::extend1 computes
// it (C: the C array at the four bases' codes)
template <class Rank, class P = typename Rank::Pos>
__device__ __forceinline__ void extend_base(const Rank& rk,
                                            const EntryRows<Rank>& e,
                                            const P* __restrict__ Cg,
                                            const P (&C)[4], P k, P kp, P s,
                                            int b, P& ok, P& okp, P& os) {
  if constexpr (kIsCkpt<Rank>) {
    const int qe = pgt::comp_code(base_code(b));
    const uint64_t m1 = (1ull << (k & 63)) - 1, m2 = (1ull << ((k + s) & 63)) - 1;
    const int2 s1 = pair_in(e.r1, qe);
    uint64_t eq1, lt1;
    Rank::masks(e.r1[0], make_int2(e.r1[1].x, e.r1[1].y), qe, eq1, lt1);
    P sl1, sh1;
    rk.super_pair(e.row1, qe, sl1, sh1);
    P r1, d, dlt;
    r1 = static_cast<P>(s1.y - s1.x + __popcll(eq1 & m1)) + (sh1 - sl1);
    if (e.row2 != e.row1) {
      const int2 s2 = pair_in(e.r2, qe);
      uint64_t eq2, lt2;
      Rank::masks(e.r2[0], make_int2(e.r2[1].x, e.r2[1].y), qe, eq2, lt2);
      P sl2, sh2;
      rk.super_pair(e.row2, qe, sl2, sh2);
      d = static_cast<P>(s2.y - s2.x + __popcll(eq2 & m2)) + (sh2 - sl2) - r1;
      dlt = static_cast<P>(s2.x + __popcll(lt2 & m2)) + sl2 -
            static_cast<P>(s1.x + __popcll(lt1 & m1)) - sl1;
    } else {
      // both ends in one row; an s < 0 counts nothing, as in rank.cuh
      const uint64_t range = m2 & ~m1;
      d = __popcll(eq1 & range);
      dlt = __popcll(lt1 & range);
    }
    const bool good = d > 0;
    ok = good ? r1 + C[b] : 0;
    okp = good ? kp + dlt : 0;
    os = good ? d : 0;
  } else {
    pgt::extend1(rk, e.r, Cg, k, kp, s, base_code(b), false, ok, okp, os);
  }
}

template <class Rank, class P = typename Rank::Pos>
__global__ void __launch_bounds__(kBlock)
sdict_level_kernel(Rank rk, const P* __restrict__ Cg,
                   const int64_t* __restrict__ keys_in,
                   const P* __restrict__ vals_in, Segments sg, int thresh,
                   int level, unsigned long long* state,
                   unsigned int* ticket, int64_t* __restrict__ keys_out,
                   P* __restrict__ vals_out, int* __restrict__ offsets,
                   int* __restrict__ totals) {
  __shared__ int blk_s;
  __shared__ int warp_at[4][kWarps];  // kept children of the warps before
  __shared__ int base_s[4];
  rk.stage();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) blk_s = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int blk = blk_s;
  const int blocks = static_cast<int>(gridDim.x);
  const int64_t D = sg.start[4];
  const int64_t i = static_cast<int64_t>(blk) * kBlock + threadIdx.x;
  const bool live = i < D;
  int64_t key = 0;
  P k = 0, kp = 0, sz = 0;
  if (live) {
    const int64_t src = source_of(sg, i);
    key = __ldg(reinterpret_cast<const long long*>(keys_in) + src);
    k = pgt::ld(vals_in + 3 * src);
    kp = pgt::ld(vals_in + 3 * src + 1);
    sz = pgt::ld(vals_in + 3 * src + 2);
  }
  P C[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) C[b] = pgt::ld(Cg + base_code(b));
  // a thread past the entries ranks the empty interval at 0 and keeps nothing
  const EntryRows<Rank> rows = load_rows(rk, k, sz);
  P ck[4], ckp[4], cs[4];
  unsigned kept[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    extend_base(rk, rows, Cg, C, k, kp, sz, b, ck[b], ckp[b], cs[b]);
    kept[b] = __ballot_sync(0xffffffffu, live && cs[b] >= thresh);
    if (lane == 0) warp_at[b][warp] = __popc(kept[b]);
  }
  __syncthreads();
  // warp b: the block's place inside branch b
  if (warp < 4) {
    const int b = warp;
    const int c = lane < kWarps ? warp_at[b][lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    const int n_b = __shfl_sync(0xffffffffu, incl, kWarps - 1);
    if (lane < kWarps) warp_at[b][lane] = incl - c;
    unsigned long long* st = state + static_cast<int64_t>(b) * blocks;
    if (lane == 0)
      atomicExch(st + blk, (blk == 0 ? kPrefix : kAggregate) |
                               static_cast<unsigned>(n_b));
    int excl = 0;
    if (blk > 0) {
      for (int look = blk - 1;; look -= 32) {
        const int j = look - lane;
        unsigned long long s = kPrefix;  // before block 0: a prefix of 0
        if (j >= 0) {
          do {
            s = load_state(st + j);
          } while ((s >> 32) == 0);
        }
        const unsigned pre = __ballot_sync(0xffffffffu, (s >> 32) == 2);
        int v = static_cast<int>(s & 0xffffffffu);
        // up to and with the nearest predecessor that knows its prefix
        if (pre && lane > __ffs(pre) - 1) v = 0;
        excl += warp_sum(v);
        if (pre) break;
      }
      if (lane == 0) atomicExch(st + blk, kPrefix | static_cast<unsigned>(excl + n_b));
    }
    if (lane == 0) {
      base_s[b] = excl;
      offsets[static_cast<int64_t>(b) * blocks + blk] = excl;
      if (blk == blocks - 1) totals[b] = excl + n_b;
    }
  }
  __syncthreads();
  // each kept child to its place in its branch's region: a warp's children
  // of a branch are one contiguous run
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if ((kept[b] >> lane) & 1u) {
      const int64_t at = static_cast<int64_t>(b) * D + base_s[b] + warp_at[b][warp] +
                         __popc(kept[b] & below);
      keys_out[at] = key | (static_cast<int64_t>(b) << (2 * level));
      vals_out[3 * at] = ck[b];
      vals_out[3 * at + 1] = ckp[b];
      vals_out[3 * at + 2] = cs[b];
    }
  }
}

template <class Rank, class P = typename Rank::Pos>
int launch_level(const Rank& rk, const P* C, const int64_t* keys_in,
                 const P* vals_in, int regions, int64_t stride, int64_t c0,
                 int64_t c1, int64_t c2, int64_t c3, int thresh, int level,
                 int64_t blocks, void* state, int64_t* keys_out, P* vals_out,
                 int* offsets, int* totals, void* stream) {
  Segments sg;
  const int64_t counts[4] = {c0, c1, c2, c3};
  sg.start[0] = 0;
  for (int r = 0; r < 4; ++r) {
    if (counts[r] < 0 || counts[r] > stride || (r >= regions && counts[r] != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    sg.start[r + 1] = sg.start[r] + counts[r];
  }
  sg.stride = stride;
  const int64_t D = sg.start[4];
  if (regions < 1 || regions > 4 || D <= 0 || D >= (int64_t{1} << 31) ||
      blocks != (D + kBlock - 1) / kBlock || level < 0 || level > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the look-back state [4, blocks] and the ticket after it, zeroed
  cudaError_t err = cudaMemsetAsync(state, 0, (4 * blocks + 1) * 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* words = static_cast<unsigned long long*>(state);
  sdict_level_kernel<Rank><<<static_cast<unsigned>(blocks), kBlock, 0, st>>>(
      rk, C, keys_in, vals_in, sg, thresh, level, words,
      reinterpret_cast<unsigned int*>(words + 4 * blocks), keys_out, vals_out,
      offsets, totals);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One level over checkpoint tables. keys_in [regions, stride] int64 and
// vals_in [regions, stride, 3] int32 hold the level's entries, c_r of them at
// the front of region r -> keys_out [4, D] int64 and vals_out [4, D, 3] int32
// (region b: the totals[b] kept children of branch b), offsets [4, blocks]
// int32 (the block's place inside its branch), totals [4] int32. state:
// 4 * blocks + 1 words of 8 bytes of scratch.
int pgt_sdict_level_ckpt(const int* ckpt, int64_t nrows, const int* C,
                         const int64_t* keys_in, const int* vals_in,
                         int regions, int64_t stride, int64_t c0, int64_t c1,
                         int64_t c2, int64_t c3, int thresh, int level,
                         int64_t blocks, void* state, int64_t* keys_out,
                         int* vals_out, int* offsets, int* totals,
                         void* stream) {
  pgt::CkptRank<int> rk{ckpt, static_cast<int>(nrows - 1)};
  return launch_level(rk, C, keys_in, vals_in, regions, stride, c0, c1, c2, c3,
                      thresh, level, blocks, state, keys_out, vals_out,
                      offsets, totals, stream);
}

// the same over int64 positions: two-level rows (super_S [n_super, 8]
// int64), vals_in / vals_out int64
int pgt_sdict_level_ckpt64(const int* ckpt, int64_t nrows,
                           const int64_t* super_S, int64_t n_super,
                           int super_shift, const int64_t* C,
                           const int64_t* keys_in, const int64_t* vals_in,
                           int regions, int64_t stride, int64_t c0, int64_t c1,
                           int64_t c2, int64_t c3, int thresh, int level,
                           int64_t blocks, void* state, int64_t* keys_out,
                           int64_t* vals_out, int* offsets, int* totals,
                           void* stream) {
  pgt::CkptRank<int64_t> rk;
  if (!pgt::make_ckpt64(ckpt, nrows, super_S, n_super, super_shift, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_level(rk, C, keys_in, vals_in, regions, stride, c0, c1, c2, c3,
                      thresh, level, blocks, state, keys_out, vals_out,
                      offsets, totals, stream);
}

// the same over dense tables
int pgt_sdict_level_dense(const int* lines, int64_t n_lines, const int* rec,
                          int64_t n_runs, const int* C, const int64_t* keys_in,
                          const int* vals_in, int regions, int64_t stride,
                          int64_t c0, int64_t c1, int64_t c2, int64_t c3,
                          int thresh, int level, int64_t blocks, void* state,
                          int64_t* keys_out, int* vals_out, int* offsets,
                          int* totals, void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch_level(rk, C, keys_in, vals_in, regions, stride, c0, c1, c2, c3,
                      thresh, level, blocks, state, keys_out, vals_out,
                      offsets, totals, stream);
}

// the same over dense tables at int64 positions (rec and vals int64)
int pgt_sdict_level_dense64(const int* lines, int64_t n_lines, const int64_t* rec,
                            int64_t n_runs, const int64_t* C, const int64_t* keys_in,
                            const int64_t* vals_in, int regions, int64_t stride,
                            int64_t c0, int64_t c1, int64_t c2, int64_t c3,
                            int thresh, int level, int64_t blocks, void* state,
                            int64_t* keys_out, int64_t* vals_out, int* offsets,
                            int* totals, void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch_level(rk, C, keys_in, vals_in, regions, stride, c0, c1, c2, c3,
                      thresh, level, blocks, state, keys_out, vals_out,
                      offsets, totals, stream);
}

// the same over ultra rows (rank_table [n_rows, 8] int32)
int pgt_sdict_level_ultra(const int* rank_table, int64_t n_rows, const int* C,
                          const int64_t* keys_in, const int* vals_in,
                          int regions, int64_t stride, int64_t c0, int64_t c1,
                          int64_t c2, int64_t c3, int thresh, int level,
                          int64_t blocks, void* state, int64_t* keys_out,
                          int* vals_out, int* offsets, int* totals,
                          void* stream) {
  pgt::UltraRank rk{{}, reinterpret_cast<const int4*>(rank_table), n_rows};
  return launch_level(rk, C, keys_in, vals_in, regions, stride, c0, c1, c2, c3,
                      thresh, level, blocks, state, keys_out, vals_out,
                      offsets, totals, stream);
}

// the same over bucketed runs, int32 positions
int pgt_sdict_level_bucketed(const int* run_index, int64_t n_buckets, int shift,
                             const int* run_rec, const int* run_start, int64_t n_runs, const int* C,
                             const int64_t* keys_in, const int* vals_in,
                             int regions, int64_t stride, int64_t c0,
                             int64_t c1, int64_t c2, int64_t c3, int thresh,
                             int level, int64_t blocks, void* state,
                             int64_t* keys_out, int* vals_out, int* offsets,
                             int* totals, void* stream) {
  pgt::BucketRank<int> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_level(rk, C, keys_in, vals_in, regions, stride, c0, c1, c2, c3,
                      thresh, level, blocks, state, keys_out, vals_out,
                      offsets, totals, stream);
}

// the same over bucketed runs, int64 positions (vals int64)
int pgt_sdict_level_bucketed64(const int* run_index, int64_t n_buckets, int shift,
                               const int64_t* run_rec, const int64_t* run_start, int64_t n_runs,
                               const int64_t* C, const int64_t* keys_in,
                               const int64_t* vals_in, int regions,
                               int64_t stride, int64_t c0, int64_t c1,
                               int64_t c2, int64_t c3, int thresh, int level,
                               int64_t blocks, void* state, int64_t* keys_out,
                               int64_t* vals_out, int* offsets, int* totals,
                               void* stream) {
  pgt::BucketRank<int64_t> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_level(rk, C, keys_in, vals_in, regions, stride, c0, c1, c2, c3,
                      thresh, level, blocks, state, keys_out, vals_out,
                      offsets, totals, stream);
}

}  // extern "C"
