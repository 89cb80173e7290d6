// K3: MEM finding, the whole per-read state machine in one launch, one
// thread per read; before it, one launch that resolves the seed tiers for
// every read position.
//
// Replaces ops/mems.py:find_mems_impl, which on the TPU ran thousands of reads
// in lockstep lanes of a lax.while_loop: one extension for every lane per
// iteration, with one-hot selects for every per-lane table read and the
// emission buffers rewritten each iteration. Here each thread walks its own
// read through the same transitions (phases 0..5 of mems.py, the three steps
// of algorithm.hpp:653-757) with the loop state in registers; a finished read
// costs nothing, and the MEM buffers are written once per emitted MEM.
//
// What bounds it (measured on an H100 80GB HBM3 at 700 W, PERF.md): a read
// is one chain of dependent iterations (615 for the longest bench read), all
// reads run at once with about one warp to an SM scheduler, so the launch
// takes the longest chain times the latency of one iteration: every memory
// round trip that stands between an iteration's start and its end (some
// 0.3 us from L2, twice that from device memory), plus its ~300 instructions
// at the 4 to 5 cycles each that a lone warp's dependent chain gets. Bytes
// and load counts are far from any limit (halving the loads of a step
// changed nothing). The design therefore keeps round trips off the chain and
// the loop short:
// (a) one trip a step: both rank rows are loaded together (one row when both
//     ends of the interval share it), first thing in the iteration, before
//     the step's code is decoded; only the three counts the step uses are
//     computed (rank.cuh: two masks and four 64-bit popcounts over bit-plane
//     rows, where the nibble rows took some 380 instructions);
// (b) no trip for a seed: where a read enters step 1 or step 3 depends on the
//     step before, and a seed looked up there (dictionary row index, then
//     the row from device memory) put two trips, 1.2 us, into almost every
//     iteration of a warp. So resolve_seeds_kernel first writes the longest
//     passing tier (mems.py:87-116: long seed over dense m-mer row, length 0
//     = none) of every read position, one thread a position, dictionary
//     first and the m-mer table only where it misses: a pass bound by rate,
//     not by latency. Every iteration of the MEM kernel then loads the two
//     rows its step can lead to (an entry after a step at j lands on one of
//     two neighbouring positions) together with its rank rows, and an entry
//     finds its seed in registers;
// (c) the read's codes are kept eight at a time in a register and reloaded
//     when the position leaves that window;
// (d) the clearing of the output buffers is left to one coalesced fill by
//     the caller. The whole batch is one launch of each kernel.
//
// Outputs: (start << 16) | end, bwt_start and size per slot [B, M] (the
// caller zeroes them; slots past the count stay zero), the exact MEM count
// per read (it may exceed M), and optionally the number of extension steps
// each read took.
//
// Positions (the interval state, the seeds, bwt_start and size) are int32
// below n = 2^31 and int64 past it, over the two-level checkpoint rows
// (rank.cuh:CkptRank<int64_t>) or bucketed runs (BucketRank<int64_t>); the
// read positions and the packed (start, end) stay int32. The position type
// is a template parameter beside the rank provider, as in every serving
// kernel; the providers are the checkpoint rows, dense records, ultra rows
// and bucketed runs of rank.cuh (the --rank-mode choices).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

// v clamped into 0..hi
__device__ __forceinline__ int clamp_to(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// A resolved seed (k, kp, s, tier length): one 16-byte int4 for int32
// positions, 32 bytes (two 16-byte loads) for int64.
struct alignas(32) Seed64 {
  int64_t x, y, z, w;
};
template <class P>
using SeedT = std::conditional_t<sizeof(P) == 8, Seed64, int4>;

__device__ __forceinline__ int4 make_seed(int k, int kp, int s, int len) {
  return make_int4(k, kp, s, len);
}
__device__ __forceinline__ Seed64 make_seed(int64_t k, int64_t kp, int64_t s,
                                            int len) {
  return Seed64{k, kp, s, len};
}
__device__ __forceinline__ int4 load_seed(const int4* p) { return __ldg(p); }
__device__ __forceinline__ Seed64 load_seed(const Seed64* p) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
  return Seed64{a.x, a.y, b.x, b.y};
}

// Seed tiers, as the JAX engine takes them: the dense table of every m-mer's
// interval with the per-position keys of the reads, and the sparse long-seed
// dictionary with the per-position dictionary rows of the reads. A null
// table switches its tier off.
template <class P>
struct SeedTiers {
  const P* mer_table;        // [n_mer, 3] (k, kp, s)
  int64_t n_mer;
  const int* mer_keys;       // [B, W]
  const uint8_t* mer_valid;  // [B, W]
  int mer_m;
  const P* sdict_vals;       // [n_dict, 3] (k, kp, s)
  int64_t n_dict;
  const int* sdict_idx;      // [B, W], -1 = absent
  int sdict_m;

  // (k, kp, s, length) of the longest passing tier at flat position `at`
  // of the per-read arrays; length 0 = no seed
  __device__ __forceinline__ SeedT<P> lookup(int64_t at, int min_occ) const {
    if (sdict_vals != nullptr) {
      const int di = __ldg(sdict_idx + at);
      if (di >= 0) {
        const P* r = sdict_vals + 3 * pgt::clamp64(di, 0, n_dict - 1);
        const P size = pgt::ld(r + 2);
        if (size >= (min_occ > 1 ? min_occ : 1))
          return make_seed(pgt::ld(r), pgt::ld(r + 1), size, sdict_m);
      }
    }
    if (mer_table != nullptr && __ldg(mer_valid + at) != 0) {
      const P* r =
          mer_table + 3 * pgt::clamp64(__ldg(mer_keys + at), 0, n_mer - 1);
      const P size = pgt::ld(r + 2);
      if (size > 0) return make_seed(pgt::ld(r), pgt::ld(r + 1), size, mer_m);
    }
    return make_seed(P{0}, P{0}, P{0}, 0);
  }
};

// seeds [n_pos] = (k, kp, s, tier length) of every read position
template <class P>
__global__ void resolve_seeds_kernel(SeedTiers<P> tiers, int64_t n_pos,
                                     int min_occ, SeedT<P>* __restrict__ seeds) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_pos) seeds[i] = tiers.lookup(i, min_occ);
}

template <class Rank, class P = typename Rank::Pos>
__global__ void find_mems_kernel(Rank rk, const P* __restrict__ Cg,
                                 const int8_t* __restrict__ codes,
                                 const int* __restrict__ lengths,
                                 const SeedT<P>* __restrict__ seeds,
                                 int n_reads, int width, int code_stride,
                                 int min_len, int min_occ, P N, int M,
                                 int64_t max_iters, int* __restrict__ m_se,
                                 P* __restrict__ m_bwt, P* __restrict__ m_size,
                                 int* __restrict__ count,
                                 int* __restrict__ steps_out) {
  rk.stage();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_reads) return;
  const int L = width - 1;  // codes are padded with the NUL column j == L
  // the read's resolved seeds, and the two of them loaded ahead: those of
  // the positions ahead_at and ahead_at + 1 (clamped into the read)
  const SeedT<P>* sr = seeds ? seeds + static_cast<int64_t>(b) * width : nullptr;
  SeedT<P> ahead_a = make_seed(P{0}, P{0}, P{0}, 0), ahead_b = ahead_a;
  int at_a = -1, at_b = -1;
  // the read's codes, eight to a 64-bit word (rows are code_stride bytes, a
  // multiple of 8, zero past the read)
  const unsigned long long* cr = reinterpret_cast<const unsigned long long*>(
      codes + static_cast<int64_t>(b) * code_stride);
  unsigned long long window = 0;
  int window_at = -1;
  const int len = __ldg(lengths + b);
  int* se_out = m_se + static_cast<int64_t>(b) * M;
  P* bwt_out = m_bwt + static_cast<int64_t>(b) * M;
  P* size_out = m_size + static_cast<int64_t>(b) * M;

  int phase = 0, x = 0, j = 0, cnt = 0, steps = 0;
  P k = 0, kp = 0, s = 0, k2 = 0, kp2 = 0, s2 = 0;
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
      // longest passing seed tier: skips row.w extensions
      const int widx = clamp_to(enter1 ? x + min_len - 1 : j, L);
      const SeedT<P> row = widx == at_a
                               ? ahead_a
                               : (widx == at_b ? ahead_b : load_seed(sr + widx));
      const bool okrow = row.z >= min_occ && row.z > 0 && row.w > 0;
      const int len_t = static_cast<int>(row.w);
      const bool can1 = enter1 && min_len > len_t && okrow;
      const bool can3 = enter3 && j - len_t > x && okrow;
      if (can1) j = x + min_len - 1 - len_t;
      if (can3) j = j - len_t;
      if (can1 || can3) {
        k = row.x;
        kp = row.y;
        s = row.z;
      }
    }
    if (phase == 4) break;

    // --- one extension step (phase 1, 2 or 3) ---
    const bool p1 = phase == 1, p2 = phase == 2, p3 = phase == 3;
    // the interval's rank rows first: they are the round trip of the step
    const typename Rank::Rows rows = rk.load(p2 ? kp : k, s);
    if (sr != nullptr) {
      // a failed or finished step at j enters step 1 or 3 at j or j + 1
      // (forward) or at j + min_len - 1 or j + min_len (backward)
      const int base = p2 ? j : j + min_len - 1;
      at_a = clamp_to(base, L);
      at_b = clamp_to(base + 1, L);
      ahead_a = load_seed(sr + at_a);
      ahead_b = load_seed(sr + at_b);
    }
    const int jc = clamp_to(j, L);
    if ((jc >> 3) != window_at) {
      window_at = jc >> 3;
      window = __ldg(cr + window_at);
    }
    const int c = static_cast<int8_t>(window >> (8 * (jc & 7)));
    P nk, nkp, ns;
    pgt::extend1(rk, rows, Cg, k, kp, s, c, p2, nk, nkp, ns);
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

// reads (threads) per block of the MEM kernel: 32, 64 and 128 take the same
// time on an H100 (PERF.md)
constexpr int kThreads = 64;
constexpr int kResolveThreads = 256;

template <class Rank, class P = typename Rank::Pos>
int launch(const Rank& rk, const P* C, const int8_t* codes,
           const int* lengths, const SeedT<P>* seeds, int n_reads, int width,
           int code_stride, int min_len, int min_occ, P N, int M,
           int64_t max_iters, int* m_se, P* m_bwt, P* m_size, int* count,
           int* steps, void* stream) {
  if (n_reads > 0) {
    const unsigned blocks = (n_reads + kThreads - 1) / kThreads;
    find_mems_kernel<Rank><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        rk, C, codes, lengths, seeds, n_reads, width, code_stride, min_len,
        min_occ, N, M, max_iters, m_se, m_bwt, m_size, count, steps);
  }
  return static_cast<int>(cudaGetLastError());
}

// the reads (threads) of find_mems_kernel<Rank> that one SM of the current
// device keeps resident at kThreads a block
template <class Rank>
int resident_per_sm(int* lanes) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, find_mems_kernel<Rank, typename Rank::Pos>, kThreads, 0);
  *lanes = blocks * kThreads;
  return static_cast<int>(err);
}

template <class P>
int resolve(const P* mer_table, int64_t n_mer, const int* mer_keys,
            const uint8_t* mer_valid, int mer_m, const P* sdict_vals,
            int64_t n_dict, const int* sdict_idx, int sdict_m, int64_t n_pos,
            int min_occ, P* seeds, void* stream) {
  if (n_pos > 0) {
    const SeedTiers<P> tiers{mer_table,  n_mer,  mer_keys,  mer_valid, mer_m,
                             sdict_vals, n_dict, sdict_idx, sdict_m};
    resolve_seeds_kernel<P><<<static_cast<unsigned>(
                                  (n_pos + kResolveThreads - 1) / kResolveThreads),
                              kResolveThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        tiers, n_pos, min_occ, reinterpret_cast<SeedT<P>*>(seeds));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The longest passing seed tier of every read position: seeds [n_pos, 4]
// int32 (k, kp, s, tier length; length 0 = none) from the dense tier
// (mer_table [n_mer, 3], mer_keys / mer_valid [n_pos]) and the long-seed
// dictionary (sdict_vals [n_dict, 3], sdict_idx [n_pos]); a null table
// switches its tier off.
int pgt_resolve_seeds(const int* mer_table, int64_t n_mer, const int* mer_keys,
                      const uint8_t* mer_valid, int mer_m,
                      const int* sdict_vals, int64_t n_dict,
                      const int* sdict_idx, int sdict_m, int64_t n_pos,
                      int min_occ, int* seeds, void* stream) {
  return resolve(mer_table, n_mer, mer_keys, mer_valid, mer_m, sdict_vals,
                 n_dict, sdict_idx, sdict_m, n_pos, min_occ, seeds, stream);
}

// the same with int64 tables and seeds [n_pos, 4] int64 (32-byte aligned)
int pgt_resolve_seeds64(const int64_t* mer_table, int64_t n_mer,
                        const int* mer_keys, const uint8_t* mer_valid,
                        int mer_m, const int64_t* sdict_vals, int64_t n_dict,
                        const int* sdict_idx, int sdict_m, int64_t n_pos,
                        int min_occ, int64_t* seeds, void* stream) {
  return resolve(mer_table, n_mer, mer_keys, mer_valid, mer_m, sdict_vals,
                 n_dict, sdict_idx, sdict_m, n_pos, min_occ, seeds, stream);
}

// ckpt: [nrows, 16] int32 bit-plane rows (ops/tables.py:derive_rank_planes).
// codes: [n_reads, code_stride] int8, code_stride a multiple of 8 and at
// least width = read length + 1; seeds: [n_reads, width, 4] from
// pgt_resolve_seeds, or null (no seed tiers).
int pgt_find_mems_ckpt(const int* ckpt, int64_t nrows, const int* C,
                       const int8_t* codes, const int* lengths,
                       const int* seeds, int n_reads, int width,
                       int code_stride, int min_len, int min_occ, int N, int M,
                       int64_t max_iters, int* m_se, int* m_bwt, int* m_size,
                       int* count, int* steps, void* stream) {
  pgt::CkptRank<int> rk{ckpt, static_cast<int>(nrows - 1)};
  return launch(rk, C, codes, lengths, reinterpret_cast<const int4*>(seeds),
                n_reads, width, code_stride, min_len, min_occ, N, M, max_iters,
                m_se, m_bwt, m_size, count, steps, stream);
}

// int64 positions over two-level rows (super_S [n_super, 8] int64); seeds
// [n_reads, width, 4] int64 from pgt_resolve_seeds64, or null
int pgt_find_mems_ckpt64(const int* ckpt, int64_t nrows, const int64_t* super_S,
                         int64_t n_super, int super_shift, const int64_t* C,
                         const int8_t* codes, const int* lengths,
                         const int64_t* seeds, int n_reads, int width,
                         int code_stride, int min_len, int min_occ, int64_t N,
                         int M, int64_t max_iters, int* m_se, int64_t* m_bwt,
                         int64_t* m_size, int* count, int* steps,
                         void* stream) {
  pgt::CkptRank<int64_t> rk;
  if (!pgt::make_ckpt64(ckpt, nrows, super_S, n_super, super_shift, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, codes, lengths, reinterpret_cast<const Seed64*>(seeds),
                n_reads, width, code_stride, min_len, min_occ, N, M, max_iters,
                m_se, m_bwt, m_size, count, steps, stream);
}

int pgt_find_mems_dense(const int* lines, int64_t n_lines, const int* rec,
                        int64_t n_runs, const int* C, const int8_t* codes,
                        const int* lengths, const int* seeds, int n_reads,
                        int width, int code_stride, int min_len, int min_occ,
                        int N, int M, int64_t max_iters, int* m_se,
                        int* m_bwt, int* m_size, int* count, int* steps,
                        void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch(rk, C, codes, lengths, reinterpret_cast<const int4*>(seeds),
                n_reads, width, code_stride, min_len, min_occ, N, M, max_iters,
                m_se, m_bwt, m_size, count, steps, stream);
}

// dense tables at int64 positions (rec [n_runs, 8] int64), seeds from
// pgt_resolve_seeds64
int pgt_find_mems_dense64(const int* lines, int64_t n_lines, const int64_t* rec,
                          int64_t n_runs, const int64_t* C, const int8_t* codes,
                          const int* lengths, const int64_t* seeds, int n_reads,
                          int width, int code_stride, int min_len, int min_occ,
                          int64_t N, int M, int64_t max_iters, int* m_se,
                          int64_t* m_bwt, int64_t* m_size, int* count, int* steps,
                          void* stream) {
  const auto rk = pgt::make_dense(lines, n_lines, rec, n_runs);
  return launch(rk, C, codes, lengths, reinterpret_cast<const Seed64*>(seeds),
                n_reads, width, code_stride, min_len, min_occ, N, M, max_iters,
                m_se, m_bwt, m_size, count, steps, stream);
}

int pgt_find_mems_ultra(const int* rank_table, int64_t n_rows, const int* C,
                        const int8_t* codes, const int* lengths,
                        const int* seeds, int n_reads, int width,
                        int code_stride, int min_len, int min_occ, int N,
                        int M, int64_t max_iters, int* m_se, int* m_bwt,
                        int* m_size, int* count, int* steps, void* stream) {
  pgt::UltraRank rk{{}, reinterpret_cast<const int4*>(rank_table), n_rows};
  return launch(rk, C, codes, lengths, reinterpret_cast<const int4*>(seeds),
                n_reads, width, code_stride, min_len, min_occ, N, M, max_iters,
                m_se, m_bwt, m_size, count, steps, stream);
}

// bucketed runs (rank.cuh:BucketRank), int32 positions
int pgt_find_mems_bucketed(const int* run_index, int64_t n_buckets, int shift,
                           const int* run_rec, const int* run_start, int64_t n_runs, const int* C,
                           const int8_t* codes, const int* lengths,
                           const int* seeds, int n_reads, int width,
                           int code_stride, int min_len, int min_occ, int N,
                           int M, int64_t max_iters, int* m_se, int* m_bwt,
                           int* m_size, int* count, int* steps, void* stream) {
  pgt::BucketRank<int> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, codes, lengths, reinterpret_cast<const int4*>(seeds),
                n_reads, width, code_stride, min_len, min_occ, N, M, max_iters,
                m_se, m_bwt, m_size, count, steps, stream);
}

// the same over int64 positions, seeds from pgt_resolve_seeds64
int pgt_find_mems_bucketed64(const int* run_index, int64_t n_buckets, int shift,
                             const int64_t* run_rec, const int64_t* run_start, int64_t n_runs,
                             const int64_t* C, const int8_t* codes,
                             const int* lengths, const int64_t* seeds,
                             int n_reads, int width, int code_stride,
                             int min_len, int min_occ, int64_t N, int M,
                             int64_t max_iters, int* m_se, int64_t* m_bwt,
                             int64_t* m_size, int* count, int* steps,
                             void* stream) {
  pgt::BucketRank<int64_t> rk;
  if (!pgt::make_bucket(run_index, n_buckets, shift, run_rec, run_start, n_runs, &rk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rk, C, codes, lengths, reinterpret_cast<const Seed64*>(seeds),
                n_reads, width, code_stride, min_len, min_occ, N, M, max_iters,
                m_se, m_bwt, m_size, count, steps, stream);
}

// The reads of K3's instantiation for each rank provider (the suffix of its
// pgt_find_mems_* entry) that one SM of the current device keeps resident:
// the occupancy API at kThreads a block, in *lanes.
int pgt_find_mems_resident_ckpt(int* lanes) { return resident_per_sm<pgt::CkptRank<int>>(lanes); }
int pgt_find_mems_resident_ckpt64(int* lanes) {
  return resident_per_sm<pgt::CkptRank<int64_t>>(lanes);
}
int pgt_find_mems_resident_dense(int* lanes) { return resident_per_sm<pgt::DenseRank<int>>(lanes); }
int pgt_find_mems_resident_dense64(int* lanes) {
  return resident_per_sm<pgt::DenseRank<int64_t>>(lanes);
}
int pgt_find_mems_resident_ultra(int* lanes) { return resident_per_sm<pgt::UltraRank>(lanes); }
int pgt_find_mems_resident_bucketed(int* lanes) {
  return resident_per_sm<pgt::BucketRank<int>>(lanes);
}
int pgt_find_mems_resident_bucketed64(int* lanes) {
  return resident_per_sm<pgt::BucketRank<int64_t>>(lanes);
}

}  // extern "C"
