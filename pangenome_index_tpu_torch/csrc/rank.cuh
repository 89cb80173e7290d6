// Rank providers shared by the kernels, and the FMD extension built on them.
//
// Replaces the rank step of ops/rank.py:_ckpt_rank6 / ckpt_row_rank6 (the
// serving default, XLA on the TPU), the dense record fetch of
// ops/pallas_rank.py:gather_rows_pallas + rank6_pallas (Pallas), and the
// ultra (rank_table row) and bucketed (run_of + cum) forms of ops/rank.py:
// rank6 (XLA). A query is
// a dependent random row load, each thread at its own address, and the
// kernels that chain extensions (K3, K7) run about one warp to an SM
// scheduler. Measured on an H100 80GB HBM3 at 700 W (PERF.md), a step of
// such a chain costs the round trip of its loads (~0.3 us from L2) plus its
// instructions at the 4 to 5 cycles each that a lone warp's dependent chain
// gets; the number and width of the loads do not matter. The design therefore asks a provider only for the three
// numbers one extension uses (counts(), below), never for the whole
// 6-vector; lays the checkpoint row out so that each count is a mask and a
// 64-bit popcount; and, when both ends of the interval lie in the same row,
// loads and decodes that row once.
//
// Checkpoint rows serve any n: int32 positions below 2^31, int64 positions
// over two-level rows past it (CkptRank<P>). Dense records (through their
// lines, DenseRank<P>) and bucketed runs (BucketRank<P>, through the run
// index RunIndex<P>, which a model shard's runs also read: shard.cuh) serve
// both; ultra rows are int32 only.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace pgt {

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// value at index i of a six-entry register array; 0 when i is outside 0..5
// (the one-hot select semantics of the JAX code, so odd codes behave alike)
template <class P>
__device__ __forceinline__ P sel6(const P (&a)[6], int i) {
  P v = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) v = (c == i) ? a[c] : v;
  return v;
}

// code-space complement (utils/alphabet.py:COMP_CODE = [0, 5, 3, 2, 4, 1]);
// codes outside 0..5 give 0, as the one-hot sum does
__device__ __forceinline__ int comp_code(int c) {
  // one hex digit per code, code 0 lowest
  return static_cast<unsigned>(c) < 6u ? (0x142350 >> (4 * c)) & 7 : 0;
}

__device__ __forceinline__ uint64_t u64(int lo, int hi) {
  return static_cast<uint64_t>(static_cast<uint32_t>(lo)) |
         (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32);
}

// read-only loads of either position type
__device__ __forceinline__ int ld(const int* p) { return __ldg(p); }
__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// What one extension by the code `ext` needs of rank6 at pos and pos + s:
//   r1  = occ(ext, [0, pos))
//   d   = occ(ext, [pos, pos + s))
//   dlt = number of positions in [pos, pos + s) whose code c has
//         comp(c) < comp(ext): the advance of the reverse interval start
//         (the exclusive prefix of the comp-permuted delta in ops/fmd.py)
// A provider gives them in two calls: load(pos, s) issues every load whose
// address the interval alone decides, so that a caller can have them in
// flight while it still fetches and decodes the code; counts(...) takes the
// code (ext in 0..5, qe = comp_code(ext): the callers mask other codes).
//
// Backward search (K7) knows a step's code before it knows the step's range
// and uses neither dlt nor the "less than" masks: load_lf(pos, s, qe) issues
// every load of the step at once, the row's count pair of qe among them, and
// lf(...) gives only lo = r1 and inside = d.

// Checkpoint rows as bit planes: ops/tables.py:derive_rank_planes turns each
// [16] int32 checkpoint row (six occ bases, 64 four-bit codes) into a row of
// the same 64 bytes for this card:
//   words 0..5   three 64-bit planes (lo, hi words) of q = comp(code) of the
//                row's 64 positions, bit i = position i; 7 (all planes set)
//                past n, so a filler matches no code
//   words 6..15  the pairs (S[1], S[2]), (S[2], S[3]), (S[3], S[4]),
//                (S[4], S[5]), (S[5], S[6]), S[j] = number of positions
//                before the row with q < j (S[0] = 0 is not stored)
// Storing q instead of the code makes "comp(c) < comp(ext)" a bitwise
// less-than of the planes against the constant comp(ext), and the occ base of
// ext the difference S[q + 1] - S[q]; both masks cost a handful of logic
// operations on 64-bit words, and each count is one __popcll. The pairs are
// stored overlapping so that S[q] and S[q + 1] come with one aligned 8-byte
// load: a row is three loads (16 + 8 + 8 bytes of one 64-byte line), the
// first two of them before the code is known.
//
// P is the position type: int below n = 2^31, int64_t past it (the
// instantiation follows the tables' dtype). With P = int64_t the rows are the
// two-level form of ops/tables.py:build_ckpt_rows: their S[j] count from the
// start of their superblock of 2^super_shift positions (at most 2^30, so they
// still fit int32) and super_S[sb][j] (tables.derive_super_S: [n_super, 8]
// int64, S[0..6] and a pad, comp-permuted as the rows' pairs) adds the
// absolute count before superblock sb; single-level int64 tables carry one
// row of zeros. pos and pos + s may lie in different superblocks. The
// superblock table is tiny (3 rows at 2.16 G positions, 21 at 22 G) and is
// read on every step of a chain, so stage() copies it into shared memory at
// block start, and the add costs a shared-memory read, not a global load.
constexpr int kMaxSuper = 64;  // superblocks a block stages: 2^36 positions

template <class P>
struct CkptRank {
  using Pos = P;
  static constexpr bool kTwoLevel = sizeof(P) == 8;
  const int* rows;  // [nrows, 16] bit-plane rows
  P last_row;       // nrows - 1
  // P = int64_t: [n_super, 8] superblock bases, in device memory at launch
  // and in shared memory after stage(); unused for P = int
  const int64_t* super_S = nullptr;
  int n_super = 0;
  int super_shift = 62;

  // the planes of the rows of pos and pos + s (one row when they share it)
  struct Rows {
    P row1, row2;
    int4 a1, a2;
    int2 b1, b2;
  };

  // Every thread of the block calls it, before any early return.
  __device__ __forceinline__ void stage() {
    if constexpr (kTwoLevel) {
      __shared__ int64_t staged[kMaxSuper * 8];
      for (int i = threadIdx.x; i < n_super * 8; i += blockDim.x)
        staged[i] = super_S[i];
      __syncthreads();
      super_S = staged;
    }
  }

  __device__ __forceinline__ P row_of(P pos) const {
    const P r = pos >> 6;
    return r < 0 ? 0 : (r > last_row ? last_row : r);
  }

  __device__ __forceinline__ const int* row_ptr(P row) const {
    return rows + 16 * static_cast<int64_t>(row);
  }

  // S[qe] and S[qe + 1] of the superblock that holds `row` (0 and 0 for
  // P = int: the rows are absolute)
  __device__ __forceinline__ void super_pair(P row, int qe, P& lo, P& hi) const {
    if constexpr (kTwoLevel) {
      const int64_t* sp = super_S + 8 * ((row << 6) >> super_shift);
      lo = sp[qe];
      hi = sp[qe + 1];
    } else {
      lo = 0;
      hi = 0;
    }
  }

  __device__ __forceinline__ Rows load(P pos, P s) const {
    Rows r;
    r.row1 = row_of(pos);
    r.row2 = row_of(pos + s);
    const int* p1 = row_ptr(r.row1);
    r.a1 = __ldg(reinterpret_cast<const int4*>(p1));
    r.b1 = __ldg(reinterpret_cast<const int2*>(p1 + 4));
    if (r.row2 != r.row1) {  // both rows' loads are in flight together
      const int* p2 = row_ptr(r.row2);
      r.a2 = __ldg(reinterpret_cast<const int4*>(p2));
      r.b2 = __ldg(reinterpret_cast<const int2*>(p2 + 4));
    }
    return r;
  }

  // the stored pair that holds S[qe] and S[qe + 1] of a row
  __device__ __forceinline__ int2 pair_of(P row, int qe) const {
    return __ldg(reinterpret_cast<const int2*>(
        row_ptr(row) + 6 + 2 * (qe > 0 ? qe - 1 : 0)));
  }

  // s_lo, s_hi = S[qe], S[qe + 1] of a row
  __device__ __forceinline__ void below(P row, int qe, int& s_lo,
                                        int& s_hi) const {
    const int2 s = pair_of(row, qe);
    s_lo = qe > 0 ? s.x : 0;
    s_hi = qe > 0 ? s.y : s.x;
  }

  // positions of a row with q == qe, and with q < qe
  __device__ __forceinline__ static void masks(const int4& a, const int2& b,
                                               int qe, uint64_t& eq,
                                               uint64_t& lt) {
    const uint64_t p0 = u64(a.x, a.y), p1 = u64(a.z, a.w), p2 = u64(b.x, b.y);
    const uint64_t c0 = 0ull - (qe & 1), c1 = 0ull - ((qe >> 1) & 1),
                   c2 = 0ull - ((qe >> 2) & 1);
    const uint64_t x0 = ~(p0 ^ c0), x1 = ~(p1 ^ c1), x2 = ~(p2 ^ c2);
    eq = x2 & x1 & x0;
    lt = (~p2 & c2) | (x2 & ((~p1 & c1) | (x1 & ~p0 & c0)));
  }

  __device__ __forceinline__ void counts(const Rows& r, P pos, P s, int,
                                         int qe, P& r1, P& d, P& dlt) const {
    const P pos2 = pos + s;
    const uint64_t m1 = (1ull << (pos & 63)) - 1, m2 = (1ull << (pos2 & 63)) - 1;
    int lo1, hi1;
    uint64_t eq1, lt1;
    below(r.row1, qe, lo1, hi1);
    P sl1, sh1;
    super_pair(r.row1, qe, sl1, sh1);
    if (r.row2 != r.row1) {
      int lo2, hi2;
      uint64_t eq2, lt2;
      below(r.row2, qe, lo2, hi2);
      P sl2, sh2;
      super_pair(r.row2, qe, sl2, sh2);
      masks(r.a1, r.b1, qe, eq1, lt1);
      masks(r.a2, r.b2, qe, eq2, lt2);
      r1 = static_cast<P>(hi1 - lo1 + __popcll(eq1 & m1)) + (sh1 - sl1);
      d = static_cast<P>(hi2 - lo2 + __popcll(eq2 & m2)) + (sh2 - sl2) - r1;
      dlt = static_cast<P>(lo2 + __popcll(lt2 & m2)) + sl2 -
            static_cast<P>(lo1 + __popcll(lt1 & m1)) - sl1;
    } else {
      // both ends in one row (most steps of a chain: intervals are small):
      // one row decoded, the counts of the range taken with one mask. For an
      // s < 0 the range is empty and d = 0 where the difference would be
      // negative; the callers read both as a failed extension.
      masks(r.a1, r.b1, qe, eq1, lt1);
      const uint64_t range = m2 & ~m1;
      r1 = static_cast<P>(hi1 - lo1 + __popcll(eq1 & m1)) + (sh1 - sl1);
      d = __popcll(eq1 & range);
      dlt = __popcll(lt1 & range);
    }
  }

  // Backward search: the planes and the count pair of qe, of both rows
  struct LfRows {
    Rows r;
    int2 s1, s2;
  };

  // every load of one lf step, none waiting for another: the count pair's
  // address needs the code, which the caller has before the range
  __device__ __forceinline__ LfRows load_lf(P pos, P s, int qe) const {
    LfRows l;
    l.r = load(pos, s);
    l.s1 = pair_of(l.r.row1, qe);
    if (l.r.row2 != l.r.row1) l.s2 = pair_of(l.r.row2, qe);
    return l;
  }

  // positions of a row with q == qe
  __device__ __forceinline__ static uint64_t eq_mask(const int4& a,
                                                     const int2& b, int qe) {
    const uint64_t p0 = u64(a.x, a.y), p1 = u64(a.z, a.w), p2 = u64(b.x, b.y);
    const uint64_t c0 = 0ull - (qe & 1), c1 = 0ull - ((qe >> 1) & 1),
                   c2 = 0ull - ((qe >> 2) & 1);
    return ~((p0 ^ c0) | (p1 ^ c1) | (p2 ^ c2));
  }

  // lo = occ(ext, [0, pos)), inside = occ(ext, [pos, pos + s)); after the
  // rows arrive: one mask and two popcounts
  __device__ __forceinline__ void lf(const LfRows& l, P pos, P s, int,
                                     int qe, P& lo, P& inside) const {
    const P pos2 = pos + s;
    const uint64_t m1 = (1ull << (pos & 63)) - 1, m2 = (1ull << (pos2 & 63)) - 1;
    const uint64_t eq1 = eq_mask(l.r.a1, l.r.b1, qe);
    P sl1, sh1;
    super_pair(l.r.row1, qe, sl1, sh1);
    lo = static_cast<P>((qe > 0 ? l.s1.y - l.s1.x : l.s1.x) + __popcll(eq1 & m1)) +
         (sh1 - sl1);
    if (l.r.row2 != l.r.row1) {
      const uint64_t eq2 = eq_mask(l.r.a2, l.r.b2, qe);
      P sl2, sh2;
      super_pair(l.r.row2, qe, sl2, sh2);
      inside = static_cast<P>((qe > 0 ? l.s2.y - l.s2.x : l.s2.x) +
                              __popcll(eq2 & m2)) +
               (sh2 - sl2) - lo;
    } else {
      inside = __popcll(eq1 & m2 & ~m1);
    }
  }
};

// True for the checkpoint providers: their Rows are bit-plane rows, which
// a kernel may load and decode itself (csrc/sparsedict.cu).
template <class Rank>
struct IsCkptRank : std::false_type {};
template <class P>
struct IsCkptRank<CkptRank<P>> : std::true_type {};

// The int64 provider of a C entry point's arguments; false when the
// superblock table does not fit what a block stages or the shift is out of
// range (the wrappers check both before they launch).
inline bool make_ckpt64(const int* rows, int64_t nrows, const int64_t* super_S,
                        int64_t n_super, int super_shift,
                        CkptRank<int64_t>* rk) {
  if (nrows < 1 || n_super < 1 || n_super > kMaxSuper || super_shift < 6 ||
      super_shift > 62 || (((nrows - 1) << 6) >> super_shift) >= n_super)
    return false;
  rk->rows = rows;
  rk->last_row = nrows - 1;
  rk->super_S = super_S;
  rk->n_super = static_cast<int>(n_super);
  rk->super_shift = super_shift;
  return true;
}

// rank6 at both ends of an interval: the rows of the providers that read
// whole rank vectors (dense records, ultra rows, bucketed runs)
template <class P>
struct Rank6Pair {
  P a[6], b[6];  // rank6 at pos and at pos + s
};

// What the rank6-vector providers share (Self::rank6(pos, r) gives one
// vector, Self::load(pos, s) both): an extension's three counts and an LF
// step's two from the pair, so that the providers differ only in how they
// fetch a vector. No load depends on the code.
template <class Self, class P>
struct Rank6Provider {
  using Pos = P;
  using Rows = Rank6Pair<P>;
  using LfRows = Rows;

  __device__ __forceinline__ void stage() {}

  __device__ __forceinline__ const Self& self() const {
    return static_cast<const Self&>(*this);
  }

  // both vectors, their loads in flight together (a provider with a chain
  // of loads a vector overrides it to interleave the two chains)
  __device__ __forceinline__ Rows load(P pos, P s) const {
    Rows r;
    self().rank6(pos, r.a);
    self().rank6(pos + s, r.b);
    return r;
  }

  __device__ __forceinline__ void counts(const Rows& r, P, P, int ext, int qe,
                                         P& r1, P& d, P& dlt) const {
    r1 = sel6(r.a, ext);
    d = sel6(r.b, ext) - r1;
    dlt = 0;
#pragma unroll
    for (int c = 0; c < 6; ++c)
      dlt += comp_code(c) < qe ? r.b[c] - r.a[c] : 0;
  }

  // Backward search: the vectors do not depend on the code
  __device__ __forceinline__ LfRows load_lf(P pos, P s, int) const {
    return self().load(pos, s);
  }

  __device__ __forceinline__ void lf(const LfRows& r, P, P, int ext, int,
                                     P& lo, P& inside) const {
    lo = sel6(r.a, ext);
    inside = sel6(r.b, ext) - lo;
  }
};

// Dense records (the Pallas rank6_pallas: rec[j, 2:8] + onehot(rec[j, 1]) *
// (pos - rec[j, 0]), j = pos_to_run[pos]) through the lines of
// ops/tables.py:derive_dense_lines: one aligned 16-byte line for each 64
// positions from B = 64 i, (j0 = pos_to_run[B], a 64-bit mask of the run
// heads at B + 1 .. B + 63, a spare word), so that the run of p is j0 +
// popc(mask & ((2 << (p & 63)) - 1)). The lines take n/4 bytes (5 MB on a
// 20 Mbp index), which L2 (50 MB) holds, where pos_to_run takes 4n (8n at
// int64); a vector is the line, from L2, then the run's record rec [r, 8]
// of P (start, sym, cum0..cum5): 32 bytes at int32 as two 16-byte loads,
// 64 at int64 as four. The lines are int32 at either P (j0 is a run id,
// below 2^31 wherever the records fit a card). A position is clamped into
// the lines (into 0 .. n + 1: the mask is clear past the last entry) and a
// run id into the records, as the JAX gathers clamp.
template <class P>
struct DenseRank : Rank6Provider<DenseRank<P>, P> {
  const int4* lines;  // [n_lines] (j0, mask low word, mask high word, spare)
  int64_t n_lines;
  const int4* rec;    // [r, 8] of P viewed as int4 (two a record, or four)
  int64_t n_runs;

  // p's line; p is clamped into the lines' positions
  __device__ __forceinline__ int4 line(P pos, int& k) const {
    const int64_t p = clamp64(pos, 0, 64 * n_lines - 1);
    k = static_cast<int>(p & 63);
    return __ldg(lines + (p >> 6));
  }

  // the run of the position at k of line e, clamped into the records
  __device__ __forceinline__ int64_t run(const int4& e, int k) const {
    const uint64_t mask = u64(e.y, e.z) & (~0ull >> (63 - k));
    return clamp64(static_cast<int64_t>(e.x) + __popcll(mask), 0, n_runs - 1);
  }

  // rank6 at pos from the record of run j: cum + onehot(sym) * (pos - start)
  __device__ __forceinline__ void rank6_at(P pos, int64_t j, P (&r)[6]) const {
    if constexpr (sizeof(P) == 4) {  // 32 bytes: two 16-byte loads
      const int4 a = __ldg(rec + 2 * j), b = __ldg(rec + 2 * j + 1);
      const int extra = pos - a.x;
      r[0] = a.z; r[1] = a.w; r[2] = b.x; r[3] = b.y; r[4] = b.z; r[5] = b.w;
#pragma unroll
      for (int c = 0; c < 6; ++c) r[c] += (a.y == c) ? extra : 0;
    } else {  // 64 bytes: four 16-byte loads
      const longlong2* q = reinterpret_cast<const longlong2*>(rec) + 4 * j;
      const longlong2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), e = __ldg(q + 3);
      const P extra = pos - a.x;
      r[0] = b.x; r[1] = b.y; r[2] = c.x; r[3] = c.y; r[4] = e.x; r[5] = e.y;
#pragma unroll
      for (int i = 0; i < 6; ++i) r[i] += (a.y == i) ? extra : P{0};
    }
  }

  __device__ __forceinline__ void rank6(P pos, P (&r)[6]) const {
    int k;
    const int4 e = line(pos, k);
    rank6_at(pos, run(e, k), r);
  }

  // both positions' lines, then both records: two round trips a pair
  __device__ __forceinline__ Rank6Pair<P> load(P pos, P s) const {
    const P p2 = pos + s;
    int k1, k2;
    const int4 e1 = line(pos, k1), e2 = line(p2, k2);
    Rank6Pair<P> r;
    rank6_at(pos, run(e1, k1), r.a);
    rank6_at(p2, run(e2, k2), r.b);
    return r;
  }
};

// The dense provider of a C entry point's arguments: the lines [n_lines, 4]
// int32 and the records [n_runs, 8] of P.
template <class P>
inline DenseRank<P> make_dense(const int* lines, int64_t n_lines, const P* rec,
                               int64_t n_runs) {
  DenseRank<P> rk;
  rk.lines = reinterpret_cast<const int4*>(lines);
  rk.n_lines = n_lines;
  rk.rec = reinterpret_cast<const int4*>(rec);
  rk.n_runs = n_runs;
  return rk;
}

// Ultra rows: rank_table [n+2, 8] int32, row p = occ of each code before p
// (columns 6, 7 zero: 32 bytes). One row a vector as two 16-byte loads, the
// row index clamped into the table; the rows of pos and pos + s are loaded
// together. The reference builds them for n < 2^31 only.
struct UltraRank : Rank6Provider<UltraRank, int> {
  const int4* rows;  // [n_rows, 8] viewed as [n_rows, 2] int4
  int64_t n_rows;

  __device__ __forceinline__ void rank6(int pos, int (&r)[6]) const {
    const int64_t p = clamp64(pos, 0, n_rows - 1);
    const int4 a = __ldg(rows + 2 * p), b = __ldg(rows + 2 * p + 1);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w; r[4] = b.x; r[5] = b.y;
  }
};

// The run index of bucketed runs (ops/tables.py:derive_run_index): one
// aligned 16-byte entry for each bucket of 2^shift positions (base B), from
// bucket `first` on, and the runs' records rec [n_runs, 8] of P (start,
// sym, cum0..cum5: 32 bytes at int32, 64 at int64). An entry holds
//   bytes 0..4   j0, the last run whose head is <= B (signed, 40 bits)
//   byte  5      how many heads of the runs after j0 start in the bucket
//                (saturated at 255)
//   bytes 6..15  the first of those heads' offsets h - B, ascending: ten of
//                8 bits below shift 8, else five of 16; unused slots all
//                ones, above every offset d = p - B within a bucket
// The run of p is j0 + the stored offsets <= d, counted by SIMD byte (or
// half-word) compares of the entry's last three words against d; then
// rank6 = cum + onehot(sym) * (p - start) from the record. So a rank6
// vector is two dependent loads: the entry, then the record (two 16-byte
// loads at int32, four at int64). Only where a bucket holds more heads than
// its entry and every stored one is <= d are the heads after them read from
// run_start, a 64-byte line at a time (16 int32 or 8 int64 heads, issued
// together), counted where <= p, until a line is not all counted: exact for
// any run length. The shift is chosen so that a bucket holds one to two
// heads on average. A bucket index is clamped into the index and d into
// [0, 2^shift - 1], so positions past the last bucket find the last run
// whose head is <= p.
template <class P>
struct RunIndex {
  static constexpr int kHeads = 64 / static_cast<int>(sizeof(P));
  const int4* index;  // [n_buckets] entries
  int64_t n_buckets;
  int64_t first;      // the bucket of index[0]: 0, or a model shard's first
  int shift;          // 0..15
  const P* rec;       // [n_runs, 8]
  const P* run_start; // [n_runs], read only past a full entry
  int64_t n_runs;

  // p's entry, and d = p - B clamped into the bucket
  __device__ __forceinline__ int4 entry(P p, int& d) const {
    const int64_t b =
        clamp64((static_cast<int64_t>(p) >> shift) - first, 0, n_buckets - 1);
    d = static_cast<int>(clamp64(static_cast<int64_t>(p) - ((b + first) << shift), 0,
                                 (int64_t{1} << shift) - 1));
    return __ldg(index + b);
  }

  // the run of p from its entry
  __device__ __forceinline__ int64_t run(const int4& e, int d, P p) const {
    const int64_t j0 = static_cast<int64_t>(static_cast<uint32_t>(e.x)) |
                       (static_cast<int64_t>(static_cast<int8_t>(e.y & 0xFF)) << 32);
    const int cnt = (e.y >> 8) & 0xFF;
    // the offset slots: the high half of word 1 (its low half set to ones,
    // which never counts), words 2 and 3
    const unsigned w1 = static_cast<unsigned>(e.y) | 0xFFFFu;
    const unsigned w2 = static_cast<unsigned>(e.z), w3 = static_cast<unsigned>(e.w);
    int c, cap;
    if (shift < 8) {
      const unsigned dd = static_cast<unsigned>(d) * 0x01010101u;
      c = (__popc(__vcmpleu4(w1, dd)) + __popc(__vcmpleu4(w2, dd)) +
           __popc(__vcmpleu4(w3, dd))) >> 3;
      cap = 10;
    } else {
      const unsigned dd = static_cast<unsigned>(d) * 0x00010001u;
      c = (__popc(__vcmpleu2(w1, dd)) + __popc(__vcmpleu2(w2, dd)) +
           __popc(__vcmpleu2(w3, dd))) >> 4;
      cap = 5;
    }
    int64_t j = j0 + c;
    if (cnt > cap && c == cap) j = scan(j, p);
    return j;
  }

  // past a full entry: the heads after run j, a line at a time (a run id
  // below 0, an earlier model shard's run in a shard's slice, lies below
  // every position the shard owns: it counts without a read)
  __device__ __noinline__ int64_t scan(int64_t j, P p) const {
    bool more = true;
    while (more) {
      P h[kHeads];
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        const int64_t at = j + 1 + i;
        h[i] = at >= 0 && at < n_runs ? ld(run_start + at) : P{0};
      }
      int c = 0;
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        const int64_t at = j + 1 + i;
        c += at < 0 || (at < n_runs && h[i] <= p);
      }
      j += c;
      more = c == kHeads;
    }
    return j;
  }

  // the record of run j (clamped into the records)
  __device__ __forceinline__ void record(int64_t j, P (&v)[8]) const {
    j = clamp64(j, 0, n_runs - 1);
    if constexpr (sizeof(P) == 4) {  // 32 bytes: two 16-byte loads
      const int4* q = reinterpret_cast<const int4*>(rec) + 2 * j;
      const int4 a = __ldg(q), b = __ldg(q + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {  // 64 bytes: four 16-byte loads
      const longlong2* q = reinterpret_cast<const longlong2*>(rec) + 4 * j;
      const longlong2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), e = __ldg(q + 3);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
      v[4] = c.x; v[5] = c.y; v[6] = e.x; v[7] = e.y;
    }
  }

  // rank6 at p from its run's record: cum + onehot(sym) * (p - start)
  __device__ __forceinline__ static void rank6_of(const P (&v)[8], P p, P (&r)[6]) {
    const P extra = p - v[0];
    const int sym = static_cast<int>(v[1]);
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c] = v[2 + c] + (sym == c ? extra : P{0});
  }

  __device__ __forceinline__ void rank6_at(P p, int64_t j, P (&r)[6]) const {
    P v[8];
    record(j, v);
    rank6_of(v, p, r);
  }
};

// Bucketed runs (ops/rank.py:run_of + the cum rank6, XLA on the TPU)
// through their run index: a vector is two dependent loads, and load()
// issues both positions' entries together, then both records, so that a
// pair is two round trips.
template <class P>
struct BucketRank : Rank6Provider<BucketRank<P>, P> {
  RunIndex<P> ix;

  __device__ __forceinline__ void rank6(P pos, P (&r)[6]) const {
    int d;
    const int4 e = ix.entry(pos, d);
    ix.rank6_at(pos, ix.run(e, d, pos), r);
  }

  __device__ __forceinline__ Rank6Pair<P> load(P pos, P s) const {
    const P p2 = pos + s;
    int d1, d2;
    const int4 e1 = ix.entry(pos, d1), e2 = ix.entry(p2, d2);
    const int64_t j1 = ix.run(e1, d1, pos), j2 = ix.run(e2, d2, p2);
    P v1[8], v2[8];
    ix.record(j1, v1);
    ix.record(j2, v2);
    Rank6Pair<P> r;
    ix.rank6_of(v1, pos, r.a);
    ix.rank6_of(v2, p2, r.b);
    return r;
  }
};

// The bucketed provider of a C entry point's arguments: the run index
// [n_buckets, 4] int32 over buckets of 2^shift positions, the records
// [n_runs, 8] and run_start [n_runs] of P; false when a table is empty or
// the shift is out of range (the wrappers check the shapes before they
// launch).
template <class P>
inline bool make_bucket(const int* index, int64_t n_buckets, int shift, const P* rec,
                        const P* run_start, int64_t n_runs, BucketRank<P>* rk) {
  if (n_buckets < 1 || n_runs < 1 || shift < 0 || shift > 15) return false;
  rk->ix = RunIndex<P>{reinterpret_cast<const int4*>(index), n_buckets, 0, shift, rec,
                       run_start, n_runs};
  return true;
}

// One bidirectional FMD extension (ops/fmd.py:extend) of the interval
// (k, kp, s) by `code`; forward lanes swap k/kp and complement the code.
// Failed extensions (s' <= 0) and codes outside 0..5 give (0, 0, 0).
// `rows` = rk.load(forward ? kp : k, s), issued by the caller as early as it
// knows the interval; Cg: the index's C array (exclusive prefix counts per
// code) in global memory.
template <class Rank, class P = typename Rank::Pos>
__device__ __forceinline__ void extend1(const Rank& rk,
                                        const typename Rank::Rows& rows,
                                        const P* __restrict__ Cg, P k, P kp,
                                        P s, int code, bool forward, P& ok,
                                        P& okp, P& os) {
  // ext = forward ? comp(code) : code, qe = comp(ext); a code outside 0..5
  // complements to 0 and, going backward, matches nothing
  const bool valid = static_cast<unsigned>(code) < 6u;
  const int cv = valid ? code : 0, cc = comp_code(code);
  const int ext = forward ? cc : cv, qe = forward ? cv : cc;
  const bool known = forward || valid;
  const P bk = forward ? kp : k;
  const P bkp = forward ? k : kp;
  const P c_e = ld(Cg + ext);
  P r1, d, dlt;
  rk.counts(rows, bk, s, ext, qe, r1, d, dlt);
  const bool good = known && d > 0;
  const P gk = good ? r1 + c_e : 0, gkp = good ? bkp + dlt : 0;
  ok = forward ? gkp : gk;
  okp = forward ? gk : gkp;
  os = good ? d : 0;
}

}  // namespace pgt
