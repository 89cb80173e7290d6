// One lockstep iteration of the MEM state machine for every read: the step
// of the model-sharded engine (ops/mems.py:find_mems_lockstep), fused with
// the rank partials of the positions it makes.
//
// Replaces the body of the lax.while_loop of ops/mems.py:find_mems_impl as
// parallel/engine.py:make_distributed_mem_step and
// make_distributed_serving_step run it with a model-sharded rank provider
// (an XLA program under shard_map on the TPU, a psum over 'model' inside
// every iteration). K3 (csrc/mems.cu) runs each read to its end in one
// thread, and a collective cannot sit inside a kernel; so here one launch is
// one iteration: it applies the ranks that the shards' partials summed to
// (ranks [2B, 6]: rank6 at each read's bk, then at bk + s, where bk is kp in
// phase 2 and k otherwise: both recomputed from the state the thread loads),
// makes that iteration's transitions and emissions (ops/mems.py:
// find_mems_plain, the phases 0..5 and the bint2 bookkeeping), and enters
// the next iteration (phase 0 starts a find_mems_function call, phase 5 step
// 3, both seeded from the resolved seed tiers). `apply` 0 only enters the
// first iteration. Two-level rows give counts relative to their superblock:
// the step adds super_base [n_super, 6 + shift] (ops/tables.py ckpt_super)
// of each queried position, after the sum, as the JAX program adds it after
// its psum. Where `active` is given, the launch adds the number of reads
// still active after it (warp ballots, one atomic a warp).
//
// Then the partials of the next iteration's rank queries (bk and bk + s
// for an active read, zeros for the others), over the table of the shards
// this process holds (csrc/shard.cuh, by value in the launch's parameters),
// written in place over the read's two rows of ranks, which the thread
// loaded before: thread b alone reads and writes rows b and B + b:
//   checkpoint the owning shard's bit-plane rows (3a's body);
//   runs       the owning shard's runs through its slice of the run index
//              (3b's body: the position's bucket entry, then its run's
//              record), both positions' entries loaded together, then
//              both records: two round trips a read.
// The owning shard is found by a binary search over the table's first rows
// or heads (kernel parameters, no load). With every shard of the index in
// the table (virtual shards on one card) the partial is the rank6; with a
// mesh's one shard the caller
// sums the partials over the model group (one all_reduce) before the next
// launch. So an iteration of the engine is one launch, plus the all_reduce
// under a mesh, and the engine replays ACTIVE_CHECK_EVERY of them as one
// CUDA graph.
//
// State (device memory, one entry a read): phase, x, j (int32); the
// interval k, kp, s and the last complete one k2, kp2, s2 (position type
// P); the MEM count (int32) and buffers (start << 16 | end int32, bwt_start
// and size of P, [B, capacity]); optionally the extension steps taken.
//
// What bounds it: bytes. A read's iteration loads its state (~40 bytes), two
// rank vectors (48 or 96 bytes), one code, and an entry's seed, and stores
// the state; then it loads the owning rows (64 bytes a position) or the
// owning entries (16 bytes) and runs' records (32 or 64 bytes), and stores
// two rank vectors. One thread a read; the rank rows depend on the state
// just made, a chain of one gather (two through runs). Across the loop the
// iterations are as many as the longest read takes steps: latency decides
// its time, which the graph's replay keeps to the kernel's own (PERF.md).
#include <cstdint>

#include <cuda_runtime.h>

#include "shard.cuh"

namespace {

constexpr int kThreads = 256;

template <class P>
struct StepArgs {
  P* ranks;                    // [2B, 6]: read where apply, then written
  int apply;                   // 0: the first launch (enter only)
  const int64_t* super_base;   // [n_super, super_width] or null
  int64_t n_super;
  int super_width;
  int super_shift;
  const P* C;                  // [7]
  const int8_t* codes;         // [B, code_stride], code 0 past the read
  int code_stride;
  const int* lengths;          // [B]
  const P* seeds;              // [B, W, 4] or null
  int B, W;                    // W = read length + 1
  int min_len;
  P min_occ, n;
  int M;                       // MEM capacity a read
  int *phase, *x, *j;
  P *k, *kp, *s, *k2, *kp2, *s2;
  int* cnt;
  int* se;                     // [B, M]
  P *bwt, *size;               // [B, M]
  int* steps;                  // [B] or null
  int* active;                 // [1] or null
  pgt::ShardTable shards;
};
// a kernel's parameters stay under the 4 KB every CUDA version takes
static_assert(sizeof(StepArgs<int64_t>) <= 4096, "the step's parameters pass 4 KB");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <class P>
__device__ __forceinline__ void load6(const P* src, P (&r)[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = src[c];
}

template <class P>
__device__ __forceinline__ void store6(P* dst, const P (&r)[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) dst[c] = r[c];
}

template <class P>
__device__ __forceinline__ void add_super(const StepArgs<P>& a, P at, P (&r)[6]) {
  int64_t sb = static_cast<int64_t>(at) >> a.super_shift;
  sb = sb < 0 ? 0 : (sb >= a.n_super ? a.n_super - 1 : sb);
  const int64_t* row = a.super_base + sb * a.super_width;
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = static_cast<P>(r[c] + row[c]);
}

// ranks aliases nothing else; ranks is read and written by the same
// thread only (rows b and B + b), so it is not __restrict__
template <class P, int Kind>
__global__ void __launch_bounds__(kThreads)
mem_step_kernel(const __grid_constant__ StepArgs<P> a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  if (b < a.B) {
    int ph = a.phase[b], x = a.x[b], j = a.j[b];
    P k = a.k[b], kp = a.kp[b], s = a.s[b];
    const int len = a.lengths[b];
    const int L = a.W - 1;
    if (a.apply && ph >= 1 && ph <= 3) {
      // the extension of this iteration (ops/fmd.py:extend on the summed
      // ranks): forward reads swap k/kp and complement the code
      const bool forward = ph == 2;
      const int code = a.codes[static_cast<int64_t>(b) * a.code_stride + clampi(j, 0, L)];
      P rk[6], rks[6];
      load6(a.ranks + 6 * static_cast<int64_t>(b), rk);
      load6(a.ranks + 6 * (static_cast<int64_t>(a.B) + b), rks);
      if (a.super_base != nullptr) {  // the positions the ranks were asked at
        const P bk = forward ? kp : k;
        add_super(a, bk, rk);
        add_super(a, static_cast<P>(bk + s), rks);
      }
      const int cc = pgt::comp_code(code);
      const int ext = forward ? cc : code;   // outside 0..5: matches nothing
      const int qe = forward ? code : cc;
      const P bkp = forward ? k : kp;
      P delta[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) delta[c] = rks[c] - rk[c];
      P dlt = 0;
      if (static_cast<unsigned>(qe) < 6u) {
#pragma unroll
        for (int c = 0; c < 6; ++c) dlt += pgt::comp_code(c) < qe ? delta[c] : P{0};
      }
      P Cv[6];
      load6(a.C, Cv);
      const P d = pgt::sel6(delta, ext);
      const bool good = d > 0;
      const P gk = good ? pgt::sel6(rk, ext) + pgt::sel6(Cv, ext) : P{0};
      const P gkp = good ? bkp + dlt : P{0};
      const P ns = good ? d : P{0};
      const P nk = forward ? gkp : gk, nkp = forward ? gk : gkp;
      const bool fail = ns < a.min_occ || ns <= 0;
      if (a.steps != nullptr) a.steps[b] += 1;

      bool emit = false;
      int e_val = 0;
      bool keep_new = false;
      if (ph == 1) {
        if (fail) {
          x = j + 1;
          ph = 0;
        } else if (j == x || j == 0) {  // step 1 complete: bint2, then step 2 or 3
          a.k2[b] = nk;
          a.kp2[b] = nkp;
          a.s2[b] = ns;
          const int e1 = x + a.min_len;
          if (e1 >= len) {
            emit = true;
            e_val = e1;
          } else {
            ph = 2;
            keep_new = true;
          }
          j = e1;
        } else {
          j -= 1;
          keep_new = true;
        }
      } else if (ph == 2) {
        if (fail) {
          emit = true;
          e_val = j;
        } else {
          a.k2[b] = nk;
          a.kp2[b] = nkp;
          a.s2[b] = ns;
          if (j + 1 >= len) {
            emit = true;
            e_val = len;
            j = len;
          } else {
            j += 1;
            keep_new = true;
          }
        }
      } else {  // ph == 3
        if (fail) {
          x = j + 1;
          ph = 0;
        } else if (j - 1 == x) {
          x += 1;
          ph = 0;
        } else {
          j -= 1;
          keep_new = true;
        }
      }
      if (keep_new) {
        k = nk;
        kp = nkp;
        s = ns;
      }
      if (emit) {
        const int c = a.cnt[b];
        if (c < a.M) {
          const int64_t slot = static_cast<int64_t>(b) * a.M + c;
          a.se[slot] = (x << 16) | e_val;
          a.bwt[slot] = a.k2[b];
          a.size[slot] = a.s2[b];
        }
        a.cnt[b] = c + 1;
        ph = 5;          // step 3 next iteration, from the full interval
        k = 0;
        kp = 0;
        s = a.n;
      }
    }
    // enter the next iteration: phase 0 starts a call at x, phase 5 step 3
    const bool enter1 = ph == 0 && !(x >= len || len - x < a.min_len);
    const bool enter3 = ph == 5;
    if (ph == 0) ph = enter1 ? 1 : 4;
    if (enter3) ph = 3;
    if (enter1) {
      j = x + a.min_len - 1;
      k = 0;
      kp = 0;
      s = a.n;
    }
    if (a.seeds != nullptr && (enter1 || enter3)) {
      const int w = clampi(enter1 ? x + a.min_len - 1 : j, 0, L);
      const P* sd = a.seeds + 4 * (static_cast<int64_t>(b) * a.W + w);
      const P rk = sd[0], rkp = sd[1], rs = sd[2], rl = sd[3];
      const bool okrow = rs >= a.min_occ && rs > 0 && rl > 0;
      const bool can1 = enter1 && a.min_len > rl && okrow;
      const bool can3 = enter3 && j - rl > x && okrow;
      if (can1) j = x + a.min_len - 1 - static_cast<int>(rl);
      if (can3) j = j - static_cast<int>(rl);
      if (can1 || can3) {
        k = rk;
        kp = rkp;
        s = rs;
      }
    }
    live = ph >= 1 && ph <= 3;
    a.phase[b] = ph;
    a.x[b] = x;
    a.j[b] = j;
    a.k[b] = k;
    a.kp[b] = kp;
    a.s[b] = s;
    // the next iteration's partials, over the rows loaded above
    const P bk = ph == 2 ? kp : k;
    P r0[6] = {0, 0, 0, 0, 0, 0}, r1[6] = {0, 0, 0, 0, 0, 0};
    if (live) pgt::shard_rank6_pair<Kind>(a.shards, bk, static_cast<P>(bk + s), r0, r1);
    store6(a.ranks + 6 * static_cast<int64_t>(b), r0);
    store6(a.ranks + 6 * (static_cast<int64_t>(a.B) + b), r1);
  }
  if (a.active != nullptr) {
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0 && m != 0) atomicAdd(a.active, __popc(m));
  }
}

template <class P>
int step_launch(P* ranks, int apply, const int64_t* super_base, int64_t n_super,
                int super_width, int super_shift, const P* C, const int8_t* codes,
                int code_stride, const int* lengths, const P* seeds, int B, int W, int min_len,
                P min_occ, P n, int M, int* phase, int* x, int* j, P* k, P* kp, P* s, P* k2,
                P* kp2, P* s2, int* cnt, int* se, P* bwt, P* size, int* steps,
                int shard_kind, int n_shards, const int64_t* shards, int* active,
                void* stream) {
  if (B < 0 || W < 1 || M < 0 || code_stride < W || ranks == nullptr ||
      (super_base != nullptr && (n_super < 1 || super_width < 6 || super_shift < 0 ||
                                 super_shift > 62)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the shard table: kShardFields int64 a shard (a, index, heads, lo, count,
  // upper, first, n_buckets, shift) in ascending lo; 1..kMaxShards of one
  // kind
  if ((shard_kind != pgt::kShardsCkpt && shard_kind != pgt::kShardsRuns) || n_shards < 1 ||
      n_shards > pgt::kMaxShards)
    return static_cast<int>(cudaErrorInvalidValue);
  pgt::ShardTable tab{};
  tab.n = n_shards;
  for (int i = 0; i < n_shards; ++i) {
    const int64_t* e = shards + pgt::kShardFields * i;
    tab.e[i] = pgt::Shard{reinterpret_cast<const void*>(e[0]),
                          reinterpret_cast<const int4*>(e[1]),
                          reinterpret_cast<const void*>(e[2]), e[3], e[4], e[5], e[6], e[7],
                          e[8]};
    if (e[0] == 0 || e[4] < 1 || (i > 0 && e[3] < tab.e[i - 1].lo) ||
        (shard_kind == pgt::kShardsRuns &&
         (e[1] == 0 || e[2] == 0 || e[7] < 1 || e[8] < 0 || e[8] > 15)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const StepArgs<P> a{ranks, apply, super_base, n_super, super_width, super_shift, C, codes,
                      code_stride, lengths, seeds, B, W, min_len, min_occ, n, M, phase, x,
                      j, k, kp, s, k2, kp2, s2, cnt, se, bwt, size, steps, active, tab};
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shard_kind == pgt::kShardsCkpt)
    mem_step_kernel<P, pgt::kShardsCkpt><<<blocks, kThreads, 0, st>>>(a);
  else
    mem_step_kernel<P, pgt::kShardsRuns><<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One iteration for B reads at int32 positions (see StepArgs for the
// arrays; apply 0: enter the first iteration only), then the next queries'
// partials over the n_shards shards of `shards` (kind 1 checkpoint rows, 2
// runs) into ranks in place.
int pgt_mem_step(int* ranks, int apply, const int64_t* super_base, int64_t n_super,
                 int super_width, int super_shift, const int* C, const int8_t* codes,
                 int code_stride, const int* lengths, const int* seeds, int B, int W,
                 int min_len, int min_occ, int n, int M, int* phase, int* x, int* j, int* k,
                 int* kp, int* s, int* k2, int* kp2, int* s2, int* cnt, int* se, int* bwt,
                 int* size, int* steps, int shard_kind, int n_shards,
                 const int64_t* shards, int* active, void* stream) {
  return step_launch(ranks, apply, super_base, n_super, super_width, super_shift, C, codes,
                     code_stride, lengths, seeds, B, W, min_len, min_occ, n, M, phase, x, j,
                     k, kp, s, k2, kp2, s2, cnt, se, bwt, size, steps, shard_kind,
                     n_shards, shards, active, stream);
}

// the same at int64 positions
int pgt_mem_step64(int64_t* ranks, int apply, const int64_t* super_base, int64_t n_super,
                   int super_width, int super_shift, const int64_t* C, const int8_t* codes,
                   int code_stride, const int* lengths, const int64_t* seeds, int B, int W,
                   int min_len, int64_t min_occ, int64_t n, int M, int* phase, int* x, int* j,
                   int64_t* k, int64_t* kp, int64_t* s, int64_t* k2, int64_t* kp2,
                   int64_t* s2, int* cnt, int* se, int64_t* bwt, int64_t* size, int* steps,
                   int shard_kind, int n_shards, const int64_t* shards,
                   int* active, void* stream) {
  return step_launch(ranks, apply, super_base, n_super, super_width, super_shift, C, codes,
                     code_stride, lengths, seeds, B, W, min_len, min_occ, n, M, phase, x, j,
                     k, kp, s, k2, kp2, s2, cnt, se, bwt, size, steps, shard_kind,
                     n_shards, shards, active, stream);
}

}  // extern "C"
