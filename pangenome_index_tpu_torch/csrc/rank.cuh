// Rank providers shared by the kernels: rank6(pos) -> occ of each of the six
// symbol codes in BWT[0, pos).
//
// Replaces the rank step of ops/rank.py:_ckpt_rank6 / ckpt_row_rank6 (the
// serving default, XLA on the TPU) and the dense record fetch of
// ops/pallas_rank.py:gather_rows_pallas + rank6_pallas (Pallas). Both are one
// dependent random load per query (64 B checkpoint row, or a 4 B run id and a
// 32 B record), so on this card they are bound by load latency, not bandwidth
// or arithmetic. The design issues each row as 16-byte read-only loads, all of
// one row in flight at once, and keeps every per-symbol count in registers
// (no dynamically indexed arrays, so nothing spills to local memory).
//
// Int32 positions and single-level checkpoint rows only (n < 2^31); the
// wrappers refuse int64 tables and a two-level ckpt_super.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pgt {

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// value at index i of a six-entry register array; 0 when i is outside 0..5
// (the one-hot select semantics of the JAX code, so odd codes behave alike)
__device__ __forceinline__ int sel6(const int (&a)[6], int i) {
  int v = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) v = (c == i) ? a[c] : v;
  return v;
}

// code-space complement (utils/alphabet.py:COMP_CODE = [0, 5, 3, 2, 4, 1]);
// codes outside 0..5 give 0, as the one-hot sum does
__device__ __forceinline__ int comp_code(int c) {
  switch (c) {
    case 0: return 0;
    case 1: return 5;
    case 2: return 3;
    case 3: return 2;
    case 4: return 4;
    case 5: return 1;
    default: return 0;
  }
}

// Checkpoint rows: [nrows, 16] int32, cols 0..5 the occ before the bucket's
// first position, cols 6..13 its 64 codes as 4-bit nibbles (LSB first, 0xF
// past n). One 64-byte row = four 16-byte loads; the count of code c among
// the first (pos & 63) nibbles is SWAR zero-nibble detection plus __popc.
struct CkptRank {
  const int4* rows;  // the [nrows, 16] table viewed as [nrows, 4] int4
  int64_t nrows;

  __device__ __forceinline__ void rank6(int pos, int (&r)[6]) const {
    const int64_t b = clamp64(static_cast<int64_t>(pos >> 6), 0, nrows - 1);
    const int4* p = rows + 4 * b;
    const int4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2),
               q3 = __ldg(p + 3);
    const unsigned words[8] = {
        static_cast<unsigned>(q1.z), static_cast<unsigned>(q1.w),
        static_cast<unsigned>(q2.x), static_cast<unsigned>(q2.y),
        static_cast<unsigned>(q2.z), static_cast<unsigned>(q2.w),
        static_cast<unsigned>(q3.x), static_cast<unsigned>(q3.y)};
    r[0] = q0.x; r[1] = q0.y; r[2] = q0.z; r[3] = q0.w; r[4] = q1.x;
    r[5] = q1.y;
    const int i = pos & 63;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      // word w keeps its first clamp(i - 8w, 0, 8) nibbles, the rest -> 0xF
      int thr = i - 8 * w;
      thr = thr < 0 ? 0 : (thr > 8 ? 8 : thr);
      const unsigned mask = thr >= 8 ? 0xFFFFFFFFu : ((1u << (4 * thr)) - 1u);
      const unsigned m = (words[w] & mask) | ~mask;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const unsigned x = m ^ (0x11111111u * static_cast<unsigned>(c));
        const unsigned nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x11111111u;
        r[c] += 8 - __popc(nz);  // 0xF fillers never match a code
      }
    }
  }
};

// Dense records: pos_to_run [n+2] int32 and rec [r, 8] int32 rows
// (start, sym, cum0..cum5). One run-id load, then one 32-byte record as two
// 16-byte loads; rank6 = cum + onehot(sym) * (pos - start).
struct DenseRank {
  const int* pos_to_run;
  int64_t n_p2r;
  const int4* rec;  // [r, 8] viewed as [r, 2] int4
  int64_t n_runs;

  __device__ __forceinline__ void rank6(int pos, int (&r)[6]) const {
    const int64_t p = clamp64(pos, 0, n_p2r - 1);
    const int64_t j = clamp64(__ldg(pos_to_run + p), 0, n_runs - 1);
    const int4 a = __ldg(rec + 2 * j), b = __ldg(rec + 2 * j + 1);
    const int extra = pos - a.x;
    r[0] = a.z; r[1] = a.w; r[2] = b.x; r[3] = b.y; r[4] = b.z; r[5] = b.w;
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c] += (a.y == c) ? extra : 0;
  }
};

// One bidirectional FMD extension (ops/fmd.py:extend) of the interval
// (k, kp, s) by `code`; forward lanes swap k/kp and complement the code.
// Failed extensions (s' <= 0) give (0, 0, 0).
template <class Rank>
__device__ __forceinline__ void extend1(const Rank& rk, const int (&C)[6],
                                        int k, int kp, int s, int code,
                                        bool forward, int& ok, int& okp,
                                        int& os) {
  const int comp_c = comp_code(code);
  const int ext = forward ? comp_c : code;
  const int comp_ext = forward ? code : comp_c;
  const int bk = forward ? kp : k;
  const int bkp = forward ? k : kp;
  int r1[6], r2[6];
  rk.rank6(bk, r1);
  rk.rank6(bk + s, r2);
  int delta[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) delta[c] = r2[c] - r1[c];
  // exclusive prefix of the comp-permuted delta, read at column comp_ext
  int acc = 0, run = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc = (i == comp_ext) ? run : acc;
    run += sel6(delta, comp_code(i));
  }
  const int ns = sel6(delta, ext);
  const int nk = sel6(r1, ext) + sel6(C, ext);
  const int nkp = bkp + acc;
  const bool good = ns > 0;
  const int gk = good ? nk : 0, gkp = good ? nkp : 0;
  ok = forward ? gkp : gk;
  okp = forward ? gk : gkp;
  os = good ? ns : 0;
}

}  // namespace pgt
