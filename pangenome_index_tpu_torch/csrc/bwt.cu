// The multi-string BWT by prefix doubling: the rotation order of a text of
// n int32 symbol keys (a line's bytes + L, its separator the line's index).
//
// Replaces pangenome_index_tpu/ops/bwt.py: _doubling_round (a two-key
// jax.lax.sort of (rank[i], rank[(i + k) % n], i) and _rerank), the initial
// one-key sort of rotation_order_device, its final argsort(rank), and the
// host numpy read-off of bwt_from_lines_device (the BWT, document array and
// suffix positions gathered through the order), XLA programs and numpy on
// the TPU's host. Three entry points, each a simple kernel chain:
//
//   pgt_bwt_sort_pairs: key[i] = rank[i] << bits | rank[(i + k) mod n]
//     (k = 0: rank[i] alone, the symbol keys of the first sort), payload i,
//     sorted by a least-significant-digit radix sort over only the key's
//     significant bits (2 bits, or bits at k = 0), 8 bits a pass. A pass
//     is three launches over tiles of kTile keys: a per-tile digit
//     histogram in shared memory (a warp's equal digits counted once, by
//     __match_any_sync), an exclusive scan of the [256, tiles] counts in
//     digit-major order (so a tile's place for a digit follows every smaller
//     digit and every earlier tile), and a stable scatter: a warp ranks its
//     512 consecutive keys inside their digits with no block barrier, the
//     tile is staged in shared memory in digit order, and its stores leave
//     in runs of one digit.
//   pgt_bwt_rerank: a bump where two adjacent sorted keys differ, an
//     inclusive scan of the bumps, and rank[order[j]] = scan[j]; the last
//     scan value (the largest rank) is written to 4 bytes that the host
//     reads, the loop's one sync a round.
//   pgt_bwt_finish: order[rank[i]] = i (rank is a permutation once the
//     rounds end), then per row j the BWT symbol of the rotation before
//     order[j], its line (a binary search of the line starts) and its
//     offset in the line.
//
// Both scans are one pass over tiles that take their place from an atomic
// ticket (so every tile before a tile has started: a look-back never waits
// for a block that is not resident) and find their prefix by a decoupled
// look-back (Merrill and Garland 2016), as csrc/sparsedict.cu does.
//
// What bounds it: bytes. A pass reads a key (8 bytes) twice and its payload
// (4) once and writes both: a round of p passes moves about 32 p bytes a key
// and 20 to form the keys, far above the inputs-and-outputs-once bound. The
// rerank's and the finish's scatters are random 4-byte stores, one a key.
// Ranks fit int32: n < 2^31 - 1, keys of at most 62 bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // ops/bwt.py:TILE
constexpr int kDigitBits = 8;             // ops/bwt.py:DIGIT_BITS
constexpr int kBins = 1 << kDigitBits;
constexpr int kWarps = kThreads / 32;
static_assert(kBins == kThreads, "a thread a digit in the scatter's prefix step");
// look-back state of a tile: flag in the high word, value low
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own sum
constexpr unsigned long long kPrefix = 2ull << 32;     // the sum of all up to it
constexpr unsigned char kEndmarker = '\n';             // utils/alphabet.py:NENDMARKER

using u64 = unsigned long long;

__device__ __forceinline__ u64 load_state(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
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

__global__ void __launch_bounds__(kThreads)
form_keys_kernel(const int* __restrict__ rank, int64_t n, int64_t k, int bits,
                 u64* __restrict__ keys, int* __restrict__ vals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  u64 key = static_cast<unsigned>(rank[i]);
  if (k > 0) {
    const int64_t j = i + k < n ? i + k : i + k - n;  // never (i + k) % n in int32
    key = (key << bits) | static_cast<unsigned>(rank[j]);
  }
  keys[i] = key;
  vals[i] = static_cast<int>(i);
}

// counts[d * tiles + t]: the keys of tile t whose digit at `shift` is d
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const u64* __restrict__ keys, int64_t n, int shift, int tiles,
                  int* __restrict__ counts) {
  __shared__ int hist[kBins];
  const int lane = threadIdx.x & 31;
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int64_t j = base + r * kThreads;
    const bool valid = j < n;
    const int d = valid ? static_cast<int>((keys[j] >> shift) & (kBins - 1)) : kBins;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  counts[static_cast<int64_t>(threadIdx.x) * tiles + blockIdx.x] = hist[threadIdx.x];
}

// in place: counts[j] = the sum of counts[0 .. j - 1], kItems a thread
__global__ void __launch_bounds__(kThreads)
scan_counts_kernel(int* __restrict__ counts, int64_t m, u64* state, unsigned* ticket) {
  const int tile = take_ticket(ticket);
  const int64_t base = static_cast<int64_t>(tile) * kTile + threadIdx.x * kItems;
  int v[kItems];
  int c = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    v[r] = base + r < m ? counts[base + r] : 0;
    c += v[r];
  }
  int at = exclusive_before(c, tile, state);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (base + r < m) counts[base + r] = at;
    at += v[r];
  }
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

// The stable scatter of one pass. A warp takes 512 consecutive keys of the
// tile, 32 a step, and ranks each inside its digit among the warp's keys
// before it (a match mask, and the warp's own counts in shared memory: no
// block barrier while ranking); the warps' counts then give each key its
// place in the tile sorted by digit, where the tile is staged in shared
// memory, so that the stores to offsets[d * tiles + t] and on leave in
// runs of one digit, consecutive threads on consecutive addresses; the
// payloads follow through the same buffer.
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const u64* __restrict__ keys_in, const int* __restrict__ vals_in,
                     int64_t n, int shift, int tiles, const int* __restrict__ offsets,
                     u64* __restrict__ keys_out, int* __restrict__ vals_out) {
  constexpr int kSteps = kItems;  // 32 keys a step, 512 a warp
  __shared__ u64 stage[kTile];               // the tile by digit: keys, then payloads
  __shared__ unsigned char digit_at[kTile];  // the digit of each staged place
  __shared__ int warp_at[kWarps][kBins];     // a warp's keys of a digit, then its first place
  __shared__ int tile_at[kBins];             // the tile's first place of a digit
  __shared__ int out_at[kBins];              // where that place goes in the output
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_at[w][threadIdx.x] = 0;
  out_at[threadIdx.x] = offsets[static_cast<int64_t>(threadIdx.x) * tiles + blockIdx.x];
  __syncthreads();
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t base = tile0 + warp * (kSteps * 32) + lane;
  int* counts = warp_at[warp];
  u64 key[kSteps];
  int place[kSteps];  // among the warp's keys of its digit
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t j = base + s * 32;
    const bool valid = j < n;
    key[s] = valid ? keys_in[j] : 0;
    const int d = valid ? static_cast<int>((key[s] >> shift) & (kBins - 1)) : kBins;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = valid ? counts[d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) counts[d] = before + __popc(peers);
    __syncwarp();
    place[s] = before + __popc(peers & below);
  }
  __syncthreads();
  {  // thread d: the warps' first places inside digit d, the digit's in the tile
    const int d = threadIdx.x;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_at[w][d];
      warp_at[w][d] = total;
      total += c;
    }
    tile_at[d] = block_exclusive(total);
  }
  __syncthreads();
  const int len = n - tile0 < kTile ? static_cast<int>(n - tile0) : kTile;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {  // place[s]: now the key's place in the tile
    if (base + s * 32 < n) {
      const int d = static_cast<int>((key[s] >> shift) & (kBins - 1));
      place[s] += tile_at[d] + counts[d];
      stage[place[s]] = key[s];
      digit_at[place[s]] = static_cast<unsigned char>(d);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < len; q += kThreads) {
    const int d = digit_at[q];
    keys_out[out_at[d] + (q - tile_at[d])] = stage[q];
  }
  __syncthreads();
  int* vstage = reinterpret_cast<int*>(stage);
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    if (base + s * 32 < n) vstage[place[s]] = vals_in[base + s * 32];
  __syncthreads();
  for (int q = threadIdx.x; q < len; q += kThreads) {
    const int d = digit_at[q];
    vals_out[out_at[d] + (q - tile_at[d])] = vstage[q];
  }
}

// rank[order[j]] = the number of j' in 1..j whose key differs from the one
// before it; *top = that number at j = n - 1
__global__ void __launch_bounds__(kThreads)
rerank_kernel(const u64* __restrict__ keys, const int* __restrict__ order, int64_t n,
              u64* state, unsigned* ticket, int* __restrict__ rank, int* __restrict__ top) {
  const int tile = take_ticket(ticket);
  const int64_t base = static_cast<int64_t>(tile) * kTile + threadIdx.x * kItems;
  unsigned bumps = 0;
  int c = 0;
  u64 prev = base > 0 && base < n ? keys[base - 1] : 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t j = base + r;
    if (j < n) {
      const u64 key = keys[j];
      if (j > 0 && key != prev) {
        bumps |= 1u << r;
        ++c;
      }
      prev = key;
    }
  }
  int at = exclusive_before(c, tile, state);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t j = base + r;
    if (j < n) {
      at += (bumps >> r) & 1u;
      rank[order[j]] = at;
      if (j == n - 1) *top = at;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
invert_kernel(const int* __restrict__ rank, int64_t n, int* __restrict__ order) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) order[rank[i]] = static_cast<int>(i);
}

// row j: the symbol before rotation order[j] (a key below n_lines is a
// separator), the line holding order[j] and its offset there
__global__ void __launch_bounds__(kThreads)
read_off_kernel(const int* __restrict__ order, const int* __restrict__ keys, int64_t n,
                const int64_t* __restrict__ line_starts, int64_t n_lines,
                uint8_t* __restrict__ bwt, int64_t* __restrict__ da,
                int64_t* __restrict__ sa_pos) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const int64_t p = order[j];
  const int64_t key = keys[p == 0 ? n - 1 : p - 1];
  bwt[j] = key >= n_lines ? static_cast<uint8_t>(key - n_lines) : kEndmarker;
  int64_t lo = 0, hi = n_lines;  // line_starts[lo] <= p < line_starts[hi]
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(line_starts + mid) <= p) lo = mid; else hi = mid;
  }
  da[j] = lo;
  sa_pos[j] = p - __ldg(line_starts + lo);
}

inline unsigned grid_of(int64_t n, int64_t per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

inline bool bad_n(int64_t n) { return n < 1 || n >= (int64_t{1} << 31) - 1; }

}  // namespace

extern "C" {

// One round's ordered pairs: keys_a [n] (uint64 in int64) and vals_a [n]
// (payload i) hold the result when `passes` is even, keys_b / vals_b when
// it is odd; passes = ceil(bits * (k > 0 ? 2 : 1) / 8) (ops/bwt.py:
// sort_passes). counts: 256 * ceil(n / kTile) int32; state: ceil(counts /
// kTile) + 1 words of 8 bytes.
int pgt_bwt_sort_pairs(const int* rank, int64_t n, int64_t k, int bits, int passes,
                       int64_t* keys_a, int* vals_a, int64_t* keys_b, int* vals_b,
                       int* counts, void* state, void* stream) {
  const int key_bits = bits * (k > 0 ? 2 : 1);
  if (bad_n(n) || k < 0 || k >= n || bits < 1 || bits > 31 ||
      passes != (key_bits + kDigitBits - 1) / kDigitBits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>(grid_of(n, kTile));
  const int64_t m = static_cast<int64_t>(kBins) * tiles;
  const int scan_tiles = static_cast<int>(grid_of(m, kTile));
  auto* words = static_cast<u64*>(state);
  u64* keys[2] = {reinterpret_cast<u64*>(keys_a), reinterpret_cast<u64*>(keys_b)};
  int* vals[2] = {vals_a, vals_b};
  form_keys_kernel<<<grid_of(n, kThreads), kThreads, 0, st>>>(rank, n, k, bits,
                                                                keys[0], vals[0]);
  cudaError_t err = cudaGetLastError();
  for (int p = 0; p < passes && err == cudaSuccess; ++p) {
    const int in = p & 1, shift = p * kDigitBits;
    radix_hist_kernel<<<tiles, kThreads, 0, st>>>(keys[in], n, shift, tiles, counts);
    err = cudaMemsetAsync(state, 0, (scan_tiles + 1) * sizeof(u64), st);
    if (err != cudaSuccess) break;
    scan_counts_kernel<<<scan_tiles, kThreads, 0, st>>>(
        counts, m, words, reinterpret_cast<unsigned*>(words + scan_tiles));
    radix_scatter_kernel<<<tiles, kThreads, 0, st>>>(keys[in], vals[in], n, shift, tiles,
                                                      counts, keys[1 - in], vals[1 - in]);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// keys [n] sorted, order [n] their payload -> rank [n] (dense, 0 ..), top
// [1] the largest; state: ceil(n / kTile) + 1 words of 8 bytes
int pgt_bwt_rerank(const int64_t* keys, const int* order, int64_t n, int* rank,
                   int* top, void* state, void* stream) {
  if (bad_n(n)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>(grid_of(n, kTile));
  auto* words = static_cast<u64*>(state);
  cudaError_t err = cudaMemsetAsync(state, 0, (tiles + 1) * sizeof(u64), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  rerank_kernel<<<tiles, kThreads, 0, st>>>(
      reinterpret_cast<const u64*>(keys), order, n, words,
      reinterpret_cast<unsigned*>(words + tiles), rank, top);
  return static_cast<int>(cudaGetLastError());
}

// rank [n] a permutation, keys [n] the symbol keys, line_starts [n_lines + 1]
// (the last is n) -> order [n], bwt [n] bytes, da [n] and sa_pos [n] int64
int pgt_bwt_finish(const int* rank, const int* keys, int64_t n,
                   const int64_t* line_starts, int64_t n_lines, int* order,
                   uint8_t* bwt, int64_t* da, int64_t* sa_pos, void* stream) {
  if (bad_n(n) || n_lines < 1 || n_lines > n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  invert_kernel<<<grid_of(n, kThreads), kThreads, 0, st>>>(rank, n, order);
  read_off_kernel<<<grid_of(n, kThreads), kThreads, 0, st>>>(order, keys, n, line_starts,
                                                             n_lines, bwt, da, sa_pos);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
