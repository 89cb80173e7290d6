// The multi-string BWT by prefix doubling: the rotation order of a text of
// n int32 symbol keys (a line's bytes + L, its separator the line's index).
//
// Replaces pangenome_index_tpu/ops/bwt.py: _doubling_round (a two-key
// jax.lax.sort of (rank[i], rank[(i + k) % n], i) and _rerank), the initial
// one-key sort of rotation_order_device, its final argsort(rank), and the
// host numpy read-off of bwt_from_lines_device (the BWT, document array and
// suffix positions gathered through the order), XLA programs and numpy on
// the TPU's host. Five entry points:
//
//   pgt_bwt_sort_pairs: the pairs key[i] = rank[i] << bits | rank[(i + k)
//     mod n] (k = 0: rank[i] alone, the symbol keys of the first sort) with
//     payload i, stably sorted by key: a least-significant-digit radix sort
//     over only the key's significant bits (2 bits, or bits at k = 0), in
//     the fewest passes of at most kMaxDigitBits bits, onesweep style
//     (Adinets and Merrill 2022):
//       - one up-front pass forms every key on the fly (a contiguous read
//         of rank and a shifted one) and counts the digits of every pass at
//         once (a block's counts in shared memory); a one-block launch a
//         pass turns them into each digit's first place;
//       - then one launch a pass. A tile of kTile keys takes its place by
//         an atomic ticket and counts its digits warp by warp in shared
//         memory, and thread d publishes the tile's count of digit d at
//         once, before any key is ranked. Each warp then ranks its 512
//         consecutive keys inside their digits, 32 a step: the lanes of a
//         digit set their bits in a shared mask by an atomic OR, and the
//         last of them adds their number to the warp's count of the digit
//         (the warp's first place inside the digit, from the counts). The
//         tile is staged in shared memory in digit order. Thread d then
//         finds the count of digit d in every tile before this one by a
//         decoupled look-back over the tiles' published counts, kWindow
//         tiles a step, and the tile's stores leave in runs of one digit.
//         The first pass forms its keys again from rank and takes i itself
//         as the payload: no key or payload array is read before it.
//     Keys stay in 8 bytes (up to 62 bits) and the payload in 4.
//   pgt_bwt_rerank_group and pgt_bwt_rerank_scatter, one call each a round:
//     a bump where two adjacent sorted keys differ, an inclusive scan of the
//     bumps, and rank[order[j]] = scan[j]; the last scan value (the largest
//     rank) is written to 4 bytes that the host reads, the loop's one sync a
//     round. The store is partitioned by destination: the first launch
//     writes the pairs (order[j], scan[j]) grouped by order[j] >> gshift (at
//     most 2^kGroupBits groups), in runs a tile and group; the second fills
//     each group's slice of rank in shared memory, one block a group, and
//     stores it whole (past n = 2^25, where a slice would not fit, it
//     stores each pair's value at its destination through L2 instead).
//   pgt_bwt_finish_symbols and pgt_bwt_finish_read_off, one call each a
//     build: the BWT, document array and suffix positions read off the
//     rotation order. The order is the last round's sort payload: the
//     rounds end when every adjacent sorted key differs, so that round's
//     payload already lists the rotations in rank order, and no inverse of
//     rank is formed. The first launch writes sym[p], the byte of key p (1
//     byte a key, read coalesced); the second reads order[j] coalesced and
//     gathers sym[order[j] - 1], finds the line by a binary search of the
//     line starts and writes the byte, the line and the offset, a row a
//     thread.
//
// The rerank's scan is one pass over tiles that take their place from an
// atomic ticket (so every tile before a tile has started: a look-back never
// waits for a block that is not resident) and find their prefix by a
// decoupled look-back (Merrill and Garland 2016), as csrc/sparsedict.cu
// does; the sort's passes take their digit offsets the same way.
//
// What bounds it: bytes. The sort's own function reads rank once and writes
// keys and payload once (16 bytes a key); the design moves 8 bytes a key in
// the up-front pass, 8 + 12 in the first digit pass and 24 in each later
// one, plus the look-back words (8 bytes a tile and digit: half a byte a
// key). The digit width: 8 bits, so that a thread owns one digit's count,
// look-back chain and store run in the tile. Wider digits would take fewer
// passes (the rounds' keys are about 2 * log2(n) bits, 50 at n = 20 M: 7
// passes of 8 bits, 5 of 10) but several digits a thread; this design has
// not been timed at another width (PERF.md). The rerank's own function
// reads keys and order and writes rank (16 bytes a key). Its store is a
// random 4-byte store a key into an array past L2, which took most of a
// one-pass rerank's time, and such stores cost several times their bytes
// even into a window that stays in L2 (PERF.md §6). So the design moves
// 12 + 8 bytes a key in its first launch and 8 + 4 in its second, whose
// only random stores go to shared memory. The group cursors lie a 128-byte
// line apart: packed in a few lines, the tiles' atomics on them slowed the
// first launch by a third. The finish's own function reads order and keys
// and writes bwt, da and sa_pos (25 bytes a key). Its gather is the one
// random access: through the keys (4 bytes a key, an array past L2 at the
// bench text's 80 MB) it cost several times its bytes, so the design
// gathers from the n-byte sym that L2 holds (20 MB there) and moves 27
// bytes a key: 4 + 1 in the first launch, 4 + 1 + 17 in the second.
// Ranks fit int32: n < 2^31 - 1, keys of at most 62 bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // ops/bwt.py:TILE
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDigitBits = 8;          // ops/bwt.py:MAX_DIGIT_BITS
constexpr int kMaxBins = 1 << kMaxDigitBits;
static_assert(kMaxBins == kThreads, "a thread a digit in the sort's tile");
constexpr int kMaxPasses = (62 + kMaxDigitBits - 1) / kMaxDigitBits;
constexpr int kHistKeys = 8;  // keys a thread of the up-front pass has in flight
constexpr int kWindow = 4;    // tiles a look-back step of the sort reads
// the rerank's destination groups: at most 2^kGroupBits, 1 << gshift
// destinations each (ops/bwt.py:GROUP_BITS, rerank_group_shift)
constexpr int kGroupBits = 10;
constexpr int kMaxGroups = 1 << kGroupBits;
constexpr int kGroupsPerThread = kMaxGroups / kThreads;
// ints from one group's cursor to the next: one 128-byte line each, so that
// the tiles' atomics on them spread over the L2's slices
constexpr int kCursorStride = 32;
constexpr int kScatterItems = 8;  // pairs a thread of the rerank's second phase reads a step
constexpr int kScatterTile = kThreads * kScatterItems;
// the second phase's groups in shared memory: at most 2^kMaxSliceShift
// destinations (128 KB), one block of kSliceThreads a group
constexpr int kMaxSliceShift = 15;
constexpr int kSliceThreads = 1024;
// look-back state of a tile: flag in the high word, value low; the sort's
// words also carry the pass's epoch (pass + 1) from bit 34, so that one
// zeroing serves every pass of a call
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own sum
constexpr unsigned long long kPrefix = 2ull << 32;     // the sum of all up to it
constexpr int kEpochShift = 34;
constexpr unsigned char kEndmarker = '\n';             // utils/alphabet.py:NENDMARKER
// keys a thread of the finish's first launch takes
constexpr int kSymbolKeys = 4;

using u64 = unsigned long long;

__device__ __forceinline__ u64 load_state(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

// the BWT byte that symbol key `key` stands for
__device__ __forceinline__ uint8_t symbol_of(int key, int64_t n_lines) {
  return key >= n_lines ? static_cast<uint8_t>(key - n_lines) : kEndmarker;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The block's tile, in the order the blocks started.
__device__ __forceinline__ int take_ticket(unsigned* ticket) {
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  return tile_s;
}

// The sum of `c` over every thread before this one: the threads of the
// block in order, and the tiles before this one, found by a decoupled
// look-back over `state` (one word a tile, zeroed before the launch).
__device__ int exclusive_before(int c, int tile, u64* state) {
  __shared__ int warp_at[kWarps];
  __shared__ int tile_at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_at[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_at[lane] : 0;
    int w_incl = w;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w_incl, d);
      if (lane >= d) w_incl += o;
    }
    const int total = __shfl_sync(0xffffffffu, w_incl, kWarps - 1);
    if (lane < kWarps) warp_at[lane] = w_incl - w;
    if (lane == 0)
      atomicExch(state + tile, (tile == 0 ? kPrefix : kAggregate) |
                                   static_cast<unsigned>(total));
    int excl = 0;
    if (tile > 0) {
      for (int look = tile - 1;; look -= 32) {
        const int j = look - lane;
        u64 s = kPrefix;  // before tile 0: a prefix of 0
        if (j >= 0) {
          do {
            s = load_state(state + j);
          } while ((s >> 32) == 0);
        }
        const unsigned pre = __ballot_sync(0xffffffffu, (s >> 32) == 2);
        int v = static_cast<int>(s & 0xffffffffu);
        // up to and with the nearest predecessor that knows its prefix
        if (pre && lane > __ffs(pre) - 1) v = 0;
        excl += warp_sum(v);
        if (pre) break;
      }
      if (lane == 0)
        atomicExch(state + tile, kPrefix | static_cast<unsigned>(excl + total));
    }
    if (lane == 0) tile_at = excl;
  }
  __syncthreads();
  return tile_at + warp_at[warp] + incl - c;
}

// The exclusive sum of v over the block's threads before this one.
__device__ int block_exclusive(int v) {
  __shared__ int warp_at[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_at[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_at[lane] : 0;
    int w_incl = w;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w_incl, d);
      if (lane >= d) w_incl += o;
    }
    if (lane < kWarps) warp_at[lane] = w_incl - w;
  }
  __syncthreads();
  return warp_at[warp] + incl - v;
}

// key i of round k: rank[i] << bits | rank[(i + k) mod n] (k = 0: rank[i])
__device__ __forceinline__ u64 pair_key(const int* __restrict__ rank, int64_t n,
                                        int64_t k, int bits, int64_t i) {
  u64 key = static_cast<unsigned>(__ldg(rank + i));
  if (k > 0) {
    const int64_t j = i + k < n ? i + k : i + k - n;  // never (i + k) % n in int32
    key = (key << bits) | static_cast<unsigned>(__ldg(rank + j));
  }
  return key;
}

// hist [passes, bins] (zeroed before): the keys whose digit of each pass is
// d. The block's counts in shared memory, added to hist at the end.
__global__ void __launch_bounds__(kThreads)
digit_hist_kernel(const int* __restrict__ rank, int64_t n, int64_t k, int bits,
                  int passes, int dbits, int* __restrict__ hist) {
  __shared__ int counts[kMaxPasses * kMaxBins];
  const int bins = 1 << dbits, all = passes * bins;
  for (int i = threadIdx.x; i < all; i += kThreads) counts[i] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kHistKeys;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads * kHistKeys + threadIdx.x;
       b < n; b += stride) {
    u64 key[kHistKeys];
#pragma unroll
    for (int r = 0; r < kHistKeys; ++r) {
      const int64_t i = b + r * kThreads;
      key[r] = i < n ? pair_key(rank, n, k, bits, i) : 0;
    }
#pragma unroll
    for (int r = 0; r < kHistKeys; ++r)
      if (b + r * kThreads < n)
        for (int p = 0; p < passes; ++p)
          atomicAdd(&counts[p * bins + static_cast<int>((key[r] >> (p * dbits)) & (bins - 1))],
                    1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < all; i += kThreads)
    if (counts[i]) atomicAdd(hist + i, counts[i]);
}

// in place, one block a pass: hist[p, d] = the keys of the pass's digits
// below d (the digit's first place in the pass's output); thread d, digit d
__global__ void __launch_bounds__(kThreads)
digit_starts_kernel(int* __restrict__ hist, int dbits) {
  const int bins = 1 << dbits, d = threadIdx.x;
  int* h = hist + static_cast<int64_t>(blockIdx.x) * bins;
  const int at = block_exclusive(d < bins ? h[d] : 0);
  if (d < bins) h[d] = at;
}

__device__ __forceinline__ u64 sort_word(unsigned epoch, u64 flag, int count) {
  return (static_cast<u64>(epoch) << kEpochShift) | flag | static_cast<unsigned>(count);
}

__device__ __forceinline__ void store_state(u64* p, u64 word) {
  *reinterpret_cast<volatile u64*>(p) = word;
}

// Dynamic shared memory of a pass's tile: the staged keys and payloads, each
// warp's counts of a digit (then its first place inside the digit) and its
// match masks, the tile's first place of each digit, and where that place
// goes in the output.
constexpr size_t kSweepSmem =
    static_cast<size_t>(kTile) * (8 + 4) + static_cast<size_t>(kWarps) * kMaxBins * (4 + 4) +
    static_cast<size_t>(kMaxBins) * (4 + 4);

// One digit pass: keys_out/vals_out = the stable order of the input by the
// digit at `shift`. kFirst: the input is the pairs of rank (pair_key, payload
// i); else keys_in/vals_in. starts: the pass's digit starts
// (digit_starts_kernel); state [tiles, bins] look-back words (zeroed before
// the call's first pass), ticket: the pass's tile counter (zeroed).
// Thread d of the block owns digit d.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads, 3)
onesweep_kernel(const int* __restrict__ rank, int64_t k, int bits,
                const u64* __restrict__ keys_in, const int* __restrict__ vals_in,
                int64_t n, int shift, int dbits, const int* __restrict__ starts,
                u64* state, unsigned* ticket, unsigned epoch,
                u64* __restrict__ keys_out, int* __restrict__ vals_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* skeys = reinterpret_cast<u64*>(smem);              // [kTile] the tile by digit
  int* svals = reinterpret_cast<int*>(skeys + kTile);     // [kTile] its payloads
  int* wcount = svals + kTile;                            // [kWarps, kMaxBins]
  auto* wmask = reinterpret_cast<unsigned*>(wcount + kWarps * kMaxBins);  // [kWarps, kMaxBins]
  int* tile_at = reinterpret_cast<int*>(wmask + kWarps * kMaxBins);     // [kMaxBins]
  int* out_at = tile_at + kMaxBins;                       // [kMaxBins] output - tile place
  const int bins = 1 << dbits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = take_ticket(ticket);
  for (int i = threadIdx.x; i < 2 * kWarps * kMaxBins; i += kThreads) wcount[i] = 0;
  const int64_t tile0 = static_cast<int64_t>(tile) * kTile;
  const int64_t base = tile0 + warp * (kItems * 32) + lane;
  u64 key[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t j = base + s * 32;
    if constexpr (kFirst)
      key[s] = j < n ? pair_key(rank, n, k, bits, j) : 0;
    else
      key[s] = j < n ? keys_in[j] : 0;
  }
  __syncthreads();
  // each warp's count of each digit, then (thread d) the warps' first places
  // inside digit d and the tile's count of it, published at once
  int* counts = wcount + warp * kMaxBins;
#pragma unroll
  for (int s = 0; s < kItems; ++s)
    if (base + s * 32 < n) atomicAdd(&counts[static_cast<int>((key[s] >> shift) & (bins - 1))], 1);
  __syncthreads();
  const int d = threadIdx.x;
  int c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = wcount[w * kMaxBins + d];
    wcount[w * kMaxBins + d] = c;
    c += x;
  }
  u64* words = state + static_cast<int64_t>(tile) * bins;
  if (d < bins) store_state(words + d, sort_word(epoch, tile == 0 ? kPrefix : kAggregate, c));
  const int at = block_exclusive(c);
  tile_at[d] = at;
  __syncthreads();
  // each key's place in the tile: the warp's keys of its digit before it (a
  // mask of the step's lanes by an atomic OR, a count by the step's last
  // lane of the digit), after the tile's and the earlier warps' keys of it
  unsigned* masks = wmask + warp * kMaxBins;
  const unsigned upto = (2u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t j = base + s * 32;
    const bool valid = j < n;
    const int dk = static_cast<int>((key[s] >> shift) & (bins - 1));
    if (valid) atomicOr(&masks[dk], 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? masks[dk] : 0u;
    const int last = 31 - __clz(peers);
    int before = 0;
    if (valid && lane == last) before = atomicAdd(&counts[dk], __popc(peers));
    before = __shfl_sync(0xffffffffu, before, last & 31);
    if (valid && lane == last) masks[dk] = 0;
    __syncwarp();
    if (valid) {
      const int q = tile_at[dk] + before + __popc(peers & upto) - 1;
      skeys[q] = key[s];
      if constexpr (kFirst)
        svals[q] = static_cast<int>(j);
      else
        svals[q] = vals_in[j];
    }
  }
  // digit d's keys in the tiles before this one: back to the nearest tile
  // that knows its prefix, kWindow tiles a step
  if (d < bins) {
    int prior = 0;
    int64_t look = tile - 1;
    bool pending = tile > 0;
    while (pending) {
      u64 w[kWindow];
#pragma unroll
      for (int q = 0; q < kWindow; ++q)
        w[q] = look - q >= 0 ? load_state(state + (look - q) * bins + d) : 0;
#pragma unroll
      for (int q = 0; q < kWindow; ++q) {
        if (!pending || (w[q] >> kEpochShift) != epoch) break;  // read it again
        prior += static_cast<int>(w[q] & 0xffffffffu);
        if (w[q] & kPrefix)
          pending = false;
        else
          --look;
      }
    }
    if (tile > 0) store_state(words + d, sort_word(epoch, kPrefix, prior + c));
    out_at[d] = __ldg(starts + d) + prior - at;
  }
  __syncthreads();
  const int len = n - tile0 < kTile ? static_cast<int>(n - tile0) : kTile;
  for (int q = threadIdx.x; q < len; q += kThreads) {
    const u64 kk = skeys[q];
    const int64_t o = out_at[static_cast<int>((kk >> shift) & (bins - 1))] + q;
    keys_out[o] = kk;
    vals_out[o] = svals[q];
  }
}

// The rerank's first phase: scan[j] = the number of j' in 1..j whose key
// differs from the one before it, *top = scan[n - 1], and the pairs
// order[j] << 32 | scan[j] stored grouped by the destination's group
// order[j] >> gshift: group g's pairs fill pairs[g << gshift ..) (order is
// a permutation, so a group holds 1 << gshift destinations, the last one
// fewer). A tile of kTile keys by ticket, warp-striped (item s of lane l of
// warp w is j = tile * kTile + w * 32 * kItems + s * 32 + l), so that every
// load of keys and order is coalesced; the bump of j compares its key with
// its lane neighbour's by a shuffle, a warp ballot a step gives the scan
// inside the warp, and lane 0 of each warp carries the warp's count through
// the decoupled look-back. The tile's pairs are then grouped in shared
// memory (a shared atomic a pair gives its place in its group), each group
// reserves its run at its cursor (one global atomic a group present), and
// the tile leaves in those runs. cursor [groups * kCursorStride], zeroed
// before.
__global__ void __launch_bounds__(kThreads)
rerank_group_kernel(const u64* __restrict__ keys, const int* __restrict__ order, int64_t n,
                    int gshift, int groups, u64* state, unsigned* ticket,
                    unsigned* cursor, u64* __restrict__ pairs, int* __restrict__ top) {
  __shared__ u64 spairs[kTile];      // the tile's pairs by group
  __shared__ int gfirst[kMaxGroups];  // a group's pairs in the tile, then its first place
  __shared__ int gout[kMaxGroups];    // a group's place in pairs - its place in spairs
  __shared__ int tile_len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = take_ticket(ticket);
  for (int g = threadIdx.x; g < groups; g += kThreads) gfirst[g] = 0;
  const int64_t base = static_cast<int64_t>(tile) * kTile + warp * (kItems * 32) + lane;
  u64 key[kItems];
  int dest[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t j = base + s * 32;
    key[s] = j < n ? keys[j] : 0;
    dest[s] = j < n ? order[j] : -1;
  }
  // the key before item 0 of lane 0; every other item's is a lane's
  // neighbour's (lane 0's: lane 31's of the step before)
  const u64 first_prev = lane == 0 && base > 0 && base < n ? keys[base - 1] : 0;
  unsigned bumps[kItems];
  int c = 0;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const u64 up = __shfl_up_sync(0xffffffffu, key[s], 1);
    const u64 last = __shfl_sync(0xffffffffu, key[s > 0 ? s - 1 : 0], 31);
    const u64 prev = lane > 0 ? up : (s > 0 ? last : first_prev);
    const int64_t j = base + s * 32;
    bumps[s] = __ballot_sync(0xffffffffu, j > 0 && j < n && key[s] != prev);
    c += __popc(bumps[s]);
  }
  int at = __shfl_sync(0xffffffffu, exclusive_before(lane == 0 ? c : 0, tile, state), 0);
  const unsigned upto = (2u << lane) - 1u;
  int val[kItems], slot[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t j = base + s * 32;
    val[s] = at + __popc(bumps[s] & upto);
    at += __popc(bumps[s]);
    if (j == n - 1) *top = val[s];
    // a destination outside [0, n) (order not a permutation) is dropped
    const bool ok = j < n && static_cast<unsigned>(dest[s]) < static_cast<unsigned>(n);
    slot[s] = ok ? atomicAdd(&gfirst[dest[s] >> gshift], 1) : -1;
  }
  __syncthreads();
  // thread t holds groups kGroupsPerThread * t ..: their first places in
  // the tile, and their runs in pairs reserved at their cursors
  int cnt[kGroupsPerThread], sum = 0;
#pragma unroll
  for (int i = 0; i < kGroupsPerThread; ++i) {
    const int g = threadIdx.x * kGroupsPerThread + i;
    cnt[i] = g < groups ? gfirst[g] : 0;
    sum += cnt[i];
  }
  int place = block_exclusive(sum);
  if (threadIdx.x == kThreads - 1) tile_len = place + sum;
#pragma unroll
  for (int i = 0; i < kGroupsPerThread; ++i) {
    const int g = threadIdx.x * kGroupsPerThread + i;
    if (g < groups) {
      gfirst[g] = place;
      const int64_t run = cnt[i] ? (static_cast<int64_t>(g) << gshift) +
                                          atomicAdd(cursor + g * kCursorStride,
                                                    static_cast<unsigned>(cnt[i]))
                                    : 0;
      gout[g] = static_cast<int>(run - place);
      place += cnt[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kItems; ++s)
    if (slot[s] >= 0)
      spairs[gfirst[dest[s] >> gshift] + slot[s]] =
          (static_cast<u64>(static_cast<unsigned>(dest[s])) << 32) | static_cast<unsigned>(val[s]);
  __syncthreads();
  for (int q = threadIdx.x; q < tile_len; q += kThreads) {
    const u64 p = spairs[q];
    const int64_t o = static_cast<int64_t>(gout[static_cast<int>(p >> 32) >> gshift]) + q;
    if (o < n) pairs[o] = p;  // a group past its size (order not a permutation) stops at n
  }
}

// The rerank's second phase where a group's slice of rank fits in shared
// memory (gshift <= kMaxSliceShift): one block a group. Its pairs, the
// group's region of pairs (order a permutation: 1 << gshift of them, the
// last group fewer), are read coalesced and each scan value is stored at its
// destination's place in the shared slice; the slice then leaves for rank
// coalesced. No random store reaches L2.
__global__ void __launch_bounds__(kSliceThreads)
rerank_slice_kernel(const u64* __restrict__ pairs, int64_t n, int gshift,
                    int* __restrict__ rank) {
  extern __shared__ int slice[];
  const int64_t lo = static_cast<int64_t>(blockIdx.x) << gshift;
  const int len = static_cast<int>(n - lo < (int64_t{1} << gshift) ? n - lo : int64_t{1} << gshift);
  for (int at = 0; at < len; at += kSliceThreads * kScatterItems) {
    u64 p[kScatterItems];
#pragma unroll
    for (int s = 0; s < kScatterItems; ++s) {
      const int i = at + s * kSliceThreads + threadIdx.x;
      p[s] = i < len ? pairs[lo + i] : ~0ull;
    }
#pragma unroll
    for (int s = 0; s < kScatterItems; ++s) {
      // a destination outside the group (order not a permutation) is dropped
      const int64_t d = static_cast<int64_t>(p[s] >> 32) - lo;
      if (d >= 0 && d < len) slice[d] = static_cast<int>(p[s] & 0xffffffffu);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kSliceThreads) rank[lo + i] = slice[i];
}

// The rerank's second phase past that (n > 2^(kGroupBits + kMaxSliceShift)):
// rank[p >> 32] = p & 0xffffffff for every pair p, kScatterItems a thread,
// coalesced loads. The blocks start in index order, so the blocks in flight
// read a window of a few groups, whose slices of rank stay in L2 until
// every sector of them is written: a sector leaves for device memory once,
// whole.
__global__ void __launch_bounds__(kThreads)
rerank_scatter_kernel(const u64* __restrict__ pairs, int64_t n, int* __restrict__ rank) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScatterTile + threadIdx.x;
  u64 p[kScatterItems];
#pragma unroll
  for (int s = 0; s < kScatterItems; ++s) {
    const int64_t j = base + s * kThreads;
    p[s] = j < n ? pairs[j] : ~0ull;
  }
#pragma unroll
  for (int s = 0; s < kScatterItems; ++s) {
    const unsigned d = static_cast<unsigned>(p[s] >> 32);
    if (d < static_cast<unsigned>(n)) rank[d] = static_cast<int>(p[s] & 0xffffffffu);
  }
}

// The finish's first launch: sym[p], the BWT byte of the row whose rotation
// starts at p + 1 (mod n), i.e. the byte of key p (a key below n_lines is a
// separator: the endmarker). A thread takes kSymbolKeys keys, one 16-byte
// load and one 4-byte store where the arrays align (vec).
__global__ void __launch_bounds__(kThreads)
finish_symbols_kernel(const int* __restrict__ keys, int64_t n, int64_t n_lines,
                      uint8_t* __restrict__ sym, bool vec) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kSymbolKeys;
  if (i >= n) return;
  if (vec && i + kSymbolKeys <= n) {
    const int4 k = *reinterpret_cast<const int4*>(keys + i);
    *reinterpret_cast<uchar4*>(sym + i) =
        make_uchar4(symbol_of(k.x, n_lines), symbol_of(k.y, n_lines),
                    symbol_of(k.z, n_lines), symbol_of(k.w, n_lines));
    return;
  }
  for (int64_t t = i; t < n && t < i + kSymbolKeys; ++t) sym[t] = symbol_of(keys[t], n_lines);
}

// the line holding position p: the last l with starts[l] <= p (starts[0] = 0,
// starts[n_lines] = n), read through the read-only cache
__device__ __forceinline__ int64_t line_of(const int64_t* __restrict__ starts,
                                           int64_t n_lines, int64_t p) {
  int64_t lo = 0, hi = n_lines;  // starts[lo] <= p < starts[hi]
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) <= p) lo = mid; else hi = mid;
  }
  return lo;
}

// The finish's second launch: row j reads p = order[j] (coalesced), gathers
// its BWT byte sym[p - 1 mod n] (1 byte from the n-byte array, which L2
// holds at the bench text's n), finds its line by a binary search of the
// line starts and writes the byte, the line and the offset (coalesced). One
// row a thread: several rows a thread, 16-byte stores, the line starts
// staged in shared memory and a grid of resident blocks striding over the
// rows each measured no faster on the bench text (PERF.md).
__global__ void __launch_bounds__(kThreads)
finish_read_off_kernel(const int* __restrict__ order, const uint8_t* __restrict__ sym,
                       int64_t n, const int64_t* __restrict__ line_starts, int64_t n_lines,
                       uint8_t* __restrict__ bwt, int64_t* __restrict__ da,
                       int64_t* __restrict__ sa_pos) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const int64_t p = order[j];
  bwt[j] = __ldg(sym + (p == 0 ? n - 1 : p - 1));
  const int64_t d = line_of(line_starts, n_lines, p);
  da[j] = d;
  sa_pos[j] = p - __ldg(line_starts + d);
}

inline unsigned grid_of(int64_t n, int64_t per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

inline bool bad_n(int64_t n) { return n < 1 || n >= (int64_t{1} << 31) - 1; }

// a group shift the rerank's shared arrays take: at most kMaxGroups groups
// of 1 << gshift destinations over 0 .. n - 1 (the caller chooses it:
// ops/bwt.py:rerank_group_shift)
inline bool bad_gshift(int64_t n, int gshift) {
  return gshift < 0 || gshift > 30 || ((n - 1) >> gshift) >= kMaxGroups;
}

}  // namespace

extern "C" {

// One round's ordered pairs: passes digit passes of dbits bits each (ops/
// bwt.py:sort_passes and digit_bits: key_bits = bits * (k > 0 ? 2 : 1),
// passes = ceil(key_bits / kMaxDigitBits), dbits = ceil(key_bits /
// passes)). Pass p writes keys_a / vals_a when p is even, keys_b / vals_b
// when it is odd: the result is in the last pass's. hist: passes << dbits
// int32; state: (ceil(n / kTile) << dbits) + passes words of 8 bytes.
int pgt_bwt_sort_pairs(const int* rank, int64_t n, int64_t k, int bits, int passes,
                       int dbits, int64_t* keys_a, int* vals_a, int64_t* keys_b,
                       int* vals_b, int* hist, void* state, void* stream) {
  const int key_bits = bits * (k > 0 ? 2 : 1);
  const int want_passes = (key_bits + kMaxDigitBits - 1) / kMaxDigitBits;
  if (bad_n(n) || k < 0 || k >= n || bits < 1 || bits > 31 || passes != want_passes ||
      passes > kMaxPasses || dbits != (key_bits + passes - 1) / passes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bins = 1 << dbits;
  const int64_t tiles = (n + kTile - 1) / kTile;
  auto* words = static_cast<u64*>(state);
  auto* tickets = reinterpret_cast<unsigned*>(words + tiles * bins);
  u64* keys[2] = {reinterpret_cast<u64*>(keys_a), reinterpret_cast<u64*>(keys_b)};
  int* vals[2] = {vals_a, vals_b};
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(onesweep_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSweepSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(onesweep_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSweepSmem));
  if (err == cudaSuccess)
    err = cudaMemsetAsync(hist, 0, static_cast<size_t>(passes) * bins * sizeof(int), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(state, 0, (tiles * bins + passes) * sizeof(u64), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t hist_blocks = (n + kThreads * kHistKeys - 1) / (kThreads * kHistKeys);
  digit_hist_kernel<<<static_cast<unsigned>(hist_blocks < 8 * sms ? hist_blocks : 8 * sms),
                      kThreads, 0, st>>>(rank, n, k, bits, passes, dbits, hist);
  digit_starts_kernel<<<passes, kThreads, 0, st>>>(hist, dbits);
  err = cudaGetLastError();
  for (int p = 0; p < passes && err == cudaSuccess; ++p) {
    const int shift = p * dbits;
    int* starts = hist + static_cast<int64_t>(p) * bins;
    u64* out_k = keys[p & 1];
    int* out_v = vals[p & 1];
    if (p == 0)
      onesweep_kernel<true><<<static_cast<unsigned>(tiles), kThreads, kSweepSmem, st>>>(
          rank, k, bits, nullptr, nullptr, n, shift, dbits, starts, words, tickets + p,
          p + 1, out_k, out_v);
    else
      onesweep_kernel<false><<<static_cast<unsigned>(tiles), kThreads, kSweepSmem, st>>>(
          rank, k, bits, keys[(p - 1) & 1], vals[(p - 1) & 1], n, shift, dbits, starts,
          words, tickets + p, p + 1, out_k, out_v);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// The rerank's first phase (rerank_group_kernel): keys [n] sorted, order
// [n] their payload (a permutation of 0 .. n - 1) -> pairs [n], grouped by
// destination, and top [1], the largest rank; gshift: groups of 1 << gshift
// destinations, at most kMaxGroups of them (the caller's plan, ops/bwt.py:
// rerank_group_shift); state: ceil(n / kTile) + 1 + groups * 16 words of
// 8 bytes (the look-back words, the ticket, the groups' cursors, a
// 128-byte line each).
int pgt_bwt_rerank_group(const int64_t* keys, const int* order, int64_t n, int gshift,
                         int64_t* pairs, int* top, void* state, void* stream) {
  if (bad_n(n) || bad_gshift(n, gshift)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>(grid_of(n, kTile));
  const int groups = static_cast<int>(((n - 1) >> gshift) + 1);
  auto* words = static_cast<u64*>(state);
  auto* ticket = reinterpret_cast<unsigned*>(words + tiles);
  cudaError_t err = cudaMemsetAsync(
      state, 0, (tiles + 1) * sizeof(u64) + static_cast<size_t>(groups) * kCursorStride * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  rerank_group_kernel<<<tiles, kThreads, 0, st>>>(
      reinterpret_cast<const u64*>(keys), order, n, gshift, groups, words, ticket,
      reinterpret_cast<unsigned*>(words + tiles + 1), reinterpret_cast<u64*>(pairs), top);
  return static_cast<int>(cudaGetLastError());
}

// The rerank's second phase: pairs [n] from pgt_bwt_rerank_group (gshift
// the same) -> rank [n], rank[order[j]] = scan[j]; one block a group with
// its slice in shared memory where gshift <= kMaxSliceShift, else the
// scatter through L2.
int pgt_bwt_rerank_scatter(const int64_t* pairs, int64_t n, int gshift, int* rank,
                           void* stream) {
  if (bad_n(n) || bad_gshift(n, gshift)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = reinterpret_cast<const u64*>(pairs);
  if (gshift > kMaxSliceShift) {
    rerank_scatter_kernel<<<grid_of(n, kScatterTile), kThreads, 0, st>>>(p, n, rank);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = static_cast<int>(sizeof(int)) << gshift;
  cudaError_t err = cudaFuncSetAttribute(
      rerank_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rerank_slice_kernel<<<static_cast<unsigned>(((n - 1) >> gshift) + 1), kSliceThreads, smem,
                        st>>>(p, n, gshift, rank);
  return static_cast<int>(cudaGetLastError());
}

// The finish's first phase: keys [n] the symbol keys -> sym [n] bytes,
// sym[p] the BWT byte of the row whose rotation starts at p + 1 (mod n).
int pgt_bwt_finish_symbols(const int* keys, int64_t n, int64_t n_lines, uint8_t* sym,
                           void* stream) {
  if (bad_n(n) || n_lines < 1 || n_lines > n) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned(keys, 16) && aligned(sym, 4);
  finish_symbols_kernel<<<grid_of(n, kThreads * kSymbolKeys), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(keys, n, n_lines, sym, vec);
  return static_cast<int>(cudaGetLastError());
}

// The finish's second phase: order [n] the rotation order (a permutation of
// 0 .. n - 1: the last round's sort payload), sym [n] from the first phase,
// line_starts [n_lines + 1] (the last is n) -> bwt [n] bytes, da [n] and
// sa_pos [n] int64.
int pgt_bwt_finish_read_off(const int* order, const uint8_t* sym, int64_t n,
                            const int64_t* line_starts, int64_t n_lines, uint8_t* bwt,
                            int64_t* da, int64_t* sa_pos, void* stream) {
  if (bad_n(n) || n_lines < 1 || n_lines > n) return static_cast<int>(cudaErrorInvalidValue);
  finish_read_off_kernel<<<grid_of(n, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(order, sym, n, line_starts,
                                                                n_lines, bwt, da, sa_pos);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
