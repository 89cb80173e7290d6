// One lockstep iteration of the MEM state machine for every read: the step
// that the model-sharded engine launches between its rank queries.
//
// Replaces the body of the lax.while_loop of ops/mems.py:find_mems_impl as
// parallel/engine.py:make_distributed_mem_step and
// make_distributed_serving_step run it with a model-sharded rank provider
// (an XLA program under shard_map on the TPU, a psum over 'model' inside
// every iteration). K3 (csrc/mems.cu) runs each read to its end in one
// thread, and a collective cannot sit inside a kernel; so here one launch is
// one iteration: it applies the ranks that the shards' partials summed to
// (ranks [2B, 6]: rank6 at each read's bk, then at bk + s), makes that
// iteration's transitions and emissions (ops/mems.py:find_mems_plain, the
// phases 0..5 and the bint2 bookkeeping), enters the next iteration (phase 0
// starts a find_mems_function call, phase 5 step 3, both seeded from the
// resolved seed tiers) and writes the positions of its rank queries into pos
// [2B]: bk and bk + s for an active read, 0 for the others (a valid position
// whose answer is not read). The launch with no ranks only enters the first
// iteration. Two-level rows give counts relative to their superblock: the
// step adds super_base [n_super, 6 + shift] (ops/tables.py ckpt_super) of
// each queried position, after the sum, as the JAX program adds it after
// its psum. Where `active` is given, the launch adds the number of reads
// still active after it (warp ballots, one atomic a warp): the caller reads
// it every few iterations, and all ranks of a model group, which hold the
// same reads and receive the same ranks, leave the loop at the same one.
//
// State (device memory, one entry a read): phase, x, j (int32); the
// interval k, kp, s and the last complete one k2, kp2, s2 (position type
// P); the MEM count (int32) and buffers (start << 16 | end int32, bwt_start
// and size of P, [B, capacity]); optionally the extension steps taken.
//
// What bounds it: bytes. A read's iteration loads its state (~40 bytes), two
// rank vectors (48 or 96 bytes), one code, and an entry's seed, and stores
// the state and two positions; one thread a read, no dependent chain inside
// a launch. Across the loop, though, the engine pays a launch of this step
// and one of each shard's rank kernel (and an all_reduce) an iteration, for
// as many iterations as the longest read takes steps: latency, not bytes,
// decides its time (PERF.md).
#include <cstdint>

#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 256;

template <class P>
struct StepArgs {
  const P* ranks;              // [2B, 6] or null: the first launch
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
  P* pos;                      // [2B]
  int* active;                 // [1] or null
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <class P>
__device__ __forceinline__ void load6(const P* __restrict__ src, P (&r)[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = src[c];
}

template <class P>
__device__ __forceinline__ void add_super(const StepArgs<P>& a, P at, P (&r)[6]) {
  int64_t sb = static_cast<int64_t>(at) >> a.super_shift;
  sb = sb < 0 ? 0 : (sb >= a.n_super ? a.n_super - 1 : sb);
  const int64_t* row = a.super_base + sb * a.super_width;
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = static_cast<P>(r[c] + row[c]);
}

template <class P>
__global__ void __launch_bounds__(kThreads) mem_step_kernel(const StepArgs<P> a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  if (b < a.B) {
    int ph = a.phase[b], x = a.x[b], j = a.j[b];
    P k = a.k[b], kp = a.kp[b], s = a.s[b];
    const int len = a.lengths[b];
    const int L = a.W - 1;
    if (a.ranks != nullptr && ph >= 1 && ph <= 3) {
      // the extension of this iteration (ops/fmd.py:extend on the summed
      // ranks): forward reads swap k/kp and complement the code
      const bool forward = ph == 2;
      const int code = a.codes[static_cast<int64_t>(b) * a.code_stride + clampi(j, 0, L)];
      P rk[6], rks[6];
      load6(a.ranks + 6 * static_cast<int64_t>(b), rk);
      load6(a.ranks + 6 * (static_cast<int64_t>(a.B) + b), rks);
      if (a.super_base != nullptr) {
        add_super(a, a.pos[b], rk);
        add_super(a, a.pos[a.B + b], rks);
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
    const P bk = ph == 2 ? kp : k;
    a.pos[b] = live ? bk : P{0};
    a.pos[a.B + b] = live ? bk + s : P{0};
    a.phase[b] = ph;
    a.x[b] = x;
    a.j[b] = j;
    a.k[b] = k;
    a.kp[b] = kp;
    a.s[b] = s;
  }
  if (a.active != nullptr) {
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0 && m != 0) atomicAdd(a.active, __popc(m));
  }
}

template <class P>
int step_launch(const P* ranks, const int64_t* super_base, int64_t n_super, int super_width,
                int super_shift, const P* C, const int8_t* codes, int code_stride,
                const int* lengths, const P* seeds, int B, int W, int min_len, P min_occ, P n,
                int M, int* phase, int* x, int* j, P* k, P* kp, P* s, P* k2, P* kp2, P* s2,
                int* cnt, int* se, P* bwt, P* size, int* steps, P* pos, int* active,
                void* stream) {
  if (B < 0 || W < 1 || M < 0 || code_stride < W ||
      (super_base != nullptr && (n_super < 1 || super_width < 6 || super_shift < 0 ||
                                 super_shift > 62)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const StepArgs<P> a{ranks, super_base, n_super, super_width, super_shift, C, codes,
                      code_stride, lengths, seeds, B, W, min_len, min_occ, n, M, phase, x,
                      j, k, kp, s, k2, kp2, s2, cnt, se, bwt, size, steps, pos, active};
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  mem_step_kernel<P><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One iteration for B reads at int32 positions (see StepArgs for the
// arrays; ranks null: enter the first iteration only).
int pgt_mem_step(const int* ranks, const int64_t* super_base, int64_t n_super,
                 int super_width, int super_shift, const int* C, const int8_t* codes,
                 int code_stride, const int* lengths, const int* seeds, int B, int W,
                 int min_len, int min_occ, int n, int M, int* phase, int* x, int* j, int* k,
                 int* kp, int* s, int* k2, int* kp2, int* s2, int* cnt, int* se, int* bwt,
                 int* size, int* steps, int* pos, int* active, void* stream) {
  return step_launch(ranks, super_base, n_super, super_width, super_shift, C, codes,
                     code_stride, lengths, seeds, B, W, min_len, min_occ, n, M, phase, x, j,
                     k, kp, s, k2, kp2, s2, cnt, se, bwt, size, steps, pos, active, stream);
}

// the same at int64 positions
int pgt_mem_step64(const int64_t* ranks, const int64_t* super_base, int64_t n_super,
                   int super_width, int super_shift, const int64_t* C, const int8_t* codes,
                   int code_stride, const int* lengths, const int64_t* seeds, int B, int W,
                   int min_len, int64_t min_occ, int64_t n, int M, int* phase, int* x, int* j,
                   int64_t* k, int64_t* kp, int64_t* s, int64_t* k2, int64_t* kp2,
                   int64_t* s2, int* cnt, int* se, int64_t* bwt, int64_t* size, int* steps,
                   int64_t* pos, int* active, void* stream) {
  return step_launch(ranks, super_base, n_super, super_width, super_shift, C, codes,
                     code_stride, lengths, seeds, B, W, min_len, min_occ, n, M, phase, x, j,
                     k, kp, s, k2, kp2, s2, cnt, se, bwt, size, steps, pos, active, stream);
}

}  // extern "C"
