// The one-card tag merge: each row's rank within its component, and the
// gather of its tag from that component's stream.
//
// Replaces parallel/merge.py:make_device_merge's step on one shard (an XLA
// program under shard_map on the TPU). On one device its all_gather is the
// identity and its cross-shard scan is zero, so what is left is
//
//   tag[i] = stream[offsets[c] + #{j < i : comp[j] = c}],  c = comp[i],
//
// and 0 where c is not in [0, C) (endmarker rows, rows whose component has
// no stream). The JAX form builds a one-hot [C, n] and cumsums it: C x n
// work and memory.
//
// The design is a stable counting sort of the rows by key = comp (C for a
// row with comp outside [0, C), so those sort last). Where each component's
// row count equals its stream's length (the host checks it before any
// launch, core/merge.py), offsets[c] is where component c's rows start in that
// sorted order, so a row's place p in it is exactly offsets[c] + its rank
// in c: tag[i] = stream[p], and the rows of key C (placed at p >= t) get 0.
// The sort is an LSD radix sort on digits of 8 bits, one pass where C <=
// 255 (every configuration the merge sees: C is the number of chromosomes),
// ceil(bits(C) / 8) passes past that; any C the JAX function takes. A pass
// is three launches:
//   pgt_merge_count  a tile of kTile keys a block: a histogram of the
//                    pass's digit in shared memory (warp-aggregated by
//                    __match_any_sync), written digit-major: counts[d][tile];
//   pgt_merge_scan   one block: the exclusive scan of counts in that order,
//                    in place (the place of digit d's first key in tile b),
//                    a warp a run of entries read coalesced;
//   pgt_merge_place  the same tiles: a key's place is its tile's base for
//                    its digit, plus the keys of that digit in earlier rounds
//                    of the tile (a running count in shared memory), in
//                    earlier warps of its round (per-warp counts in shared
//                    memory) and in lower lanes of its warp (__match_any_sync
//                    and a popcount). An earlier pass writes (key, row) at
//                    its place; the last pass writes tag[row] = stream[p].
// The work is O(n) a pass and the scan O(C / 256 x n / kTile) entries.
//
// The cross-card merge (parallel/merge.py:make_device_merge over more than
// one 'data' shard) is the same sort of a shard's rows with a per-component
// adjustment: where the shard's row of component c is the r-th of c here and
// base[c] rows of c lie on earlier shards (one all_gather of the shards'
// pgt_merge_hist counts, outside the kernel), its stream index is
// offsets[c] + base[c] + r. Its place p in the shard's sorted rows is
// local_start[c] + r, so the last pass reads stream[p + adj[c]] with adj[c]
// = offsets[c] + base[c] - local_start[c]; on one card adj is 0.
//
// What bounds it: bytes. The function reads comp (4 bytes a row) and a
// stream value (8) and writes tag (8): 20 bytes a row, 0.24 ms at 40 M rows
// and 3.35 TB/s. The one-pass design reads comp twice (count and place):
// 24 bytes a row, plus 8 bytes a tile and key value of counts.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                   // a block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                      // rounds of kThreads keys a tile
constexpr int64_t kTile = kThreads * kItems;    // keys a tile
constexpr int kRadix = 256;                     // digit values a pass, at most
constexpr int kScanThreads = 1024;

// The pass's key of element i: comp (C where comp is outside [0, C)) in the
// first pass, the earlier pass's placed key after it.
__device__ __forceinline__ int key_of(const int* __restrict__ comp,
                                      const int* __restrict__ key_in, int64_t i, int C) {
  if (key_in != nullptr) return key_in[i];
  const int c = comp[i];
  return c >= 0 && c < C ? c : C;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ comp, const int* __restrict__ key_in, int64_t n,
             int C, int shift, int radix, int64_t tiles, int64_t* __restrict__ counts) {
  __shared__ int hist[kRadix];
  for (int d = threadIdx.x; d < radix; d += kThreads) hist[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = tile0 + it * kThreads + threadIdx.x;
    // a lane past n takes digit kRadix, which no key has and is not counted
    const int dg = i < n ? (key_of(comp, key_in, i, C) >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (dg < kRadix && lane == __ffs(peers) - 1) atomicAdd(&hist[dg], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads)
    counts[d * tiles + blockIdx.x] = hist[d];
}

// Exclusive scan of counts [m] in place, one block. Warp w owns a run of
// entries (a multiple of 32 long) and reads it coalesced, a lane an entry a
// round: first the run's sum, then, after the warps' sums are scanned, the
// run again, each round scanned across the lanes by shuffles and carried to
// the next. Each pass issues kUnroll rounds' loads before it uses the
// first: a lone block has nothing else to hide their L2 latency behind, and
// a thread's own contiguous run (a lane a run) would make every load
// instruction touch 32 lines.
constexpr int kUnroll = 8;
constexpr int kScanWarps = kScanThreads / 32;

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int64_t* __restrict__ counts, int64_t m) {
  __shared__ int64_t warp_base[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per = ((m + kScanWarps - 1) / kScanWarps + 31) & ~int64_t{31};
  const int64_t a = min(m, warp * per), b = min(m, a + per);
  int64_t sum = 0;
  for (int64_t j0 = a + lane; j0 < b; j0 += 32 * kUnroll) {
    int64_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = j0 + 32 * u < b ? counts[j0 + 32 * u] : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) sum += v[u];
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) warp_base[warp] = sum;
  __syncthreads();
  if (warp == 0) {  // the warps' sums -> their exclusive prefixes
    const int64_t w = warp_base[lane];
    int64_t inc = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    warp_base[lane] = inc - w;
  }
  __syncthreads();
  int64_t carry = warp_base[warp];
  for (int64_t j0 = a + lane; j0 - lane < b; j0 += 32 * kUnroll) {
    int64_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = j0 + 32 * u < b ? counts[j0 + 32 * u] : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int64_t inc = v[u];
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      if (j0 + 32 * u < b) counts[j0 + 32 * u] = carry + inc - v[u];
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ comp, const int* __restrict__ key_in,
             const int64_t* __restrict__ row_in, int64_t n, int C, int shift, int radix,
             int64_t tiles, const int64_t* __restrict__ base, int* __restrict__ key_out,
             int64_t* __restrict__ row_out, const int64_t* __restrict__ stream, int64_t t,
             const int64_t* __restrict__ adj, int64_t* __restrict__ tag) {
  __shared__ unsigned long long next[kRadix];    // the tile's next place a digit
  __shared__ int warp_count[kWarps][kRadix];     // this round's keys a warp and digit
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = tid; d < radix; d += kThreads) {
    next[d] = static_cast<unsigned long long>(base[d * tiles + blockIdx.x]);
    for (int w = 0; w < kWarps; ++w) warp_count[w][d] = 0;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = tile0 + it * kThreads + tid;
    const bool live = i < n;
    const int key = live ? key_of(comp, key_in, i, C) : 0;
    const int dg = live ? (key >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    const bool leader = (peers & below) == 0;
    if (live && leader) warp_count[warp][dg] = __popc(peers);
    __syncthreads();
    int64_t p = 0;
    if (live) {
      p = static_cast<int64_t>(next[dg]) + __popc(peers & below);
      for (int w = 0; w < warp; ++w) p += warp_count[w][dg];
    }
    __syncthreads();  // every place of the round is read before it moves on
    if (live && leader) {
      atomicAdd(&next[dg], static_cast<unsigned long long>(__popc(peers)));
      warp_count[warp][dg] = 0;
    }
    __syncwarp();
    if (!live) continue;
    const int64_t row = row_in != nullptr ? row_in[i] : i;
    if (key_out != nullptr) {
      key_out[p] = key;
      row_out[p] = row;
    } else {
      const int64_t q = key < C && adj != nullptr ? p + adj[key] : p;
      tag[row] = key < C && q >= 0 && q < t ? stream[q] : 0;
    }
  }
}

// counts[c] += the rows of component c (0 <= c < C) among the n of comp:
// a shared-memory histogram a block where C fits kHistShared, else global
// atomics, each warp-aggregated.
constexpr int kHistShared = 8192;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ comp, int64_t n, int C,
            unsigned long long* __restrict__ counts) {
  __shared__ int hist[kHistShared];
  const bool shared = C <= kHistShared;
  if (shared) {
    for (int c = threadIdx.x; c < C; c += kThreads) hist[c] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = tile0 + it * kThreads + threadIdx.x;
    const int c = i < n ? comp[i] : -1;
    const int key = c >= 0 && c < C ? c : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      if (shared) atomicAdd(&hist[key], __popc(peers));
      else atomicAdd(&counts[key], static_cast<unsigned long long>(__popc(peers)));
    }
  }
  if (shared) {
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads)
      if (hist[c]) atomicAdd(&counts[c], static_cast<unsigned long long>(hist[c]));
  }
}

}  // namespace

extern "C" {

// counts [C] int64 (zeroed by the caller) += the rows of each component
// among comp [n] (labels outside [0, C) are not counted).
int pgt_merge_hist(const int* comp, int64_t n, int C, int64_t* counts, void* stream) {
  if (n < 0 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  hist_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      comp, n, C, reinterpret_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// One pass's histogram: the digit (key >> shift) & 255 of each of the n
// keys (comp, C where it is outside [0, C), when key_in is null; else
// key_in) into counts [radix, tiles], tiles = ceil(n / kTile).
int pgt_merge_count(const int* comp, const int* key_in, int64_t n, int C, int shift,
                    int radix, int64_t tiles, int64_t* counts, void* stream) {
  if (n <= 0 || radix < 1 || radix > kRadix || tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(comp, key_in, n, C, shift, radix,
                                                      tiles, counts);
  return static_cast<int>(cudaGetLastError());
}

// counts [m] -> its exclusive scan, in place.
int pgt_merge_scan(int64_t* counts, int64_t m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(counts, m);
  return static_cast<int>(cudaGetLastError());
}

// One pass's placement by the scanned counts (base): (key, row) at its place
// into key_out / row_out, or, in the last pass (key_out null), tag[row] =
// stream[place + adj[key]] (adj null: 0) for a key below C where that index
// lies in the stream, and 0 otherwise. row_in null: element i is row i.
int pgt_merge_place(const int* comp, const int* key_in, const int64_t* row_in, int64_t n,
                    int C, int shift, int radix, int64_t tiles, const int64_t* base,
                    int* key_out, int64_t* row_out, const int64_t* stream_vals, int64_t t,
                    const int64_t* adj, int64_t* tag, void* stream) {
  if (n <= 0 || radix < 1 || radix > kRadix || tiles != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  place_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(comp, key_in, row_in, n, C, shift, radix,
                                                      tiles, base, key_out, row_out,
                                                      stream_vals, t, adj, tag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
