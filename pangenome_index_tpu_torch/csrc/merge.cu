// The one-card tag merge and a data shard's part of the cross-card merge:
// each row's rank within its component, and the gather of its tag from that
// component's stream.
//
// Replaces parallel/merge.py:make_device_merge's step on one shard (an XLA
// program under shard_map on the TPU). On one device its all_gather is the
// identity and its cross-shard scan is zero, so what is left is
//
//   tag[i] = stream[offsets[c] + #{j < i : comp[j] = c}],  c = comp[i],
//
// and 0 where c is not in [0, C) (endmarker rows, rows whose component has
// no stream). The JAX form builds a one-hot [C, n] and cumsums it: C x n
// work and memory. Over more than one 'data' shard a row of component c
// that is the r-th of c on its shard, with base[c] rows of c on earlier
// shards (one all_gather of the shards' counts, outside the kernel), reads
// stream[offsets[c] + base[c] + r]; on one card base is 0.
//
// The design is a stable counting sort of the rows by key = comp (C for a
// row with comp outside [0, C)), an LSD radix sort on digits of 8 bits:
// one pass where C <= 255 (every configuration the merge sees: C is the
// number of chromosomes), ceil(bits(C) / 8) passes past that. A pass is one
// launch, pgt_merge_place, over tiles of kTile keys taken in the order the
// blocks start (an atomic ticket). A block loads all of its keys (8 a
// thread, each load of a warp coalesced) before its first barrier, ranks
// them in one pass (a key's rank among the tile's keys of its digit: the
// lower lanes of its warp by __match_any_sync, the earlier keys of its warp
// by a running count in shared memory, then, after the one barrier, the
// earlier warps' counts), finds the keys of each digit in the tiles before
// it by a decoupled look-back over per-tile digit counts (one word a tile
// and digit, an aggregate and then a prefix flag; a warp a digit reads 32
// tiles' words at once, as csrc/bwt.cu's rerank does), and then issues all
// of its gathers and stores. In the one pass the key is the digit: a row's
// rank within its component is its tile's earlier keys of c plus its rank
// in the tile, so the pass writes tag[i] = stream[offsets[c] + base[c] +
// rank] with no digit starts at all. Past one pass, an earlier pass writes (key, row) at
// its place in the pass's order (the digit's start, from the digit totals
// that pgt_merge_hist counted, plus the rank); the last pass reads
// stream[place - local_start[c] + offsets[c] + base[c]], local_start being
// each component's first place in the sorted rows (pgt_merge_scan of the
// components' counts).
//
// Launches: merge_rows one (one pass); a shard two: pgt_merge_hist, which
// counts the shard's rows of each component for the caller's exchange, and
// the placement. Past one pass add the digit totals (in the same histogram
// launch), the scan and a placement a pass.
//
// What bounds it: bytes. The function reads comp (4 bytes a row) and a
// stream value (8) and writes tag (8): 20 bytes a row, 0.24 ms at 40 M rows
// and 3.35 TB/s. The one-pass design reads comp once on one card and twice
// on a shard (24 bytes a row), plus 8 bytes a tile and digit of look-back
// words.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                   // a block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                       // keys a thread
constexpr int64_t kTile = kThreads * kItems;    // keys a tile
constexpr int kRadix = 256;                     // digit values a pass, at most
constexpr int kScanThreads = 1024;
// placement blocks an SM holds: 40 registers a thread (measured on the H100:
// 2048-key tiles six to an SM were faster than 4096-key tiles two to an SM
// at 89 registers, and than 1024-key tiles)
constexpr int kPlaceBlocks = 6;

using u64 = unsigned long long;

// A look-back word: the tile's count of a digit (kAggregate) or the count
// up to and with the tile (kPrefix) in the low 62 bits; 0 before either.
constexpr u64 kAggregate = 1ull << 62;
constexpr u64 kPrefix = 2ull << 62;
constexpr u64 kValue = kAggregate - 1;

__device__ __forceinline__ void store_state(u64* p, u64 word) {
  *reinterpret_cast<volatile u64*>(p) = word;
}
__device__ __forceinline__ u64 load_state(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

// The pass's key of element i: comp (C where comp is outside [0, C)) in the
// first pass, the earlier pass's placed key after it.
__device__ __forceinline__ int key_of(const int* __restrict__ comp,
                                      const int* __restrict__ key_in, int64_t i, int C) {
  if (key_in != nullptr) return key_in[i];
  const int c = comp[i];
  return c >= 0 && c < C ? c : C;
}

// The keys of digit d in the tiles before `tile`, by a warp: its lanes read
// 32 tiles' words at once (each spinning until its tile has published),
// back to the nearest tile that knows its prefix; every lane gets the sum.
__device__ int64_t look_back(const u64* state, int tile, int radix, int d) {
  const int lane = threadIdx.x & 31;
  int64_t prior = 0;
  for (int64_t look = tile - 1; look >= 0; look -= 32) {
    const int64_t j = look - lane;
    u64 w = kPrefix;  // before tile 0: a prefix of 0
    if (j >= 0) {
      do {
        w = load_state(state + j * radix + d);
      } while (w == 0);
    }
    const unsigned pre = __ballot_sync(0xffffffffu, (w & kPrefix) != 0);
    // up to and with the nearest predecessor that knows its prefix
    int64_t v = pre && lane > __ffs(pre) - 1 ? 0 : static_cast<int64_t>(w & kValue);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    prior += v;
    if (pre) break;
  }
  return prior;
}

// The exclusive sum of v over the block's threads before this one.
__device__ int64_t block_exclusive(int64_t v) {
  __shared__ int64_t warp_at[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_at[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int64_t w = lane < kWarps ? warp_at[lane] : 0;
    int64_t w_incl = w;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int64_t o = __shfl_up_sync(0xffffffffu, w_incl, d);
      if (lane >= d) w_incl += o;
    }
    if (lane < kWarps) warp_at[lane] = w_incl - w;
  }
  __syncthreads();
  return warp_at[warp] + incl - v;
}

// One pass over a tile a block. digits: the pass's digit totals [kRadix]
// (null in the one pass: no digit starts); state [tiles, radix] look-back
// words and the ticket after them, zeroed before the launch. key_out
// non-null: (key, row) at the key's place; else the last pass's tag, with
// local_start null in the one pass.
__global__ void __launch_bounds__(kThreads, kPlaceBlocks)
place_kernel(const int* __restrict__ comp, const int* __restrict__ key_in,
             const int64_t* __restrict__ row_in, int64_t n, int C, int shift, int radix,
             const int64_t* __restrict__ digits, u64* state, unsigned* ticket,
             int* __restrict__ key_out, int64_t* __restrict__ row_out,
             const int64_t* __restrict__ stream, int64_t t,
             const int64_t* __restrict__ offsets, const int64_t* __restrict__ base,
             const int64_t* __restrict__ local_start, int64_t* __restrict__ tag) {
  __shared__ int wrun[kWarps][kRadix];   // a warp's keys of a digit, then the
                                         // earlier warps' in the tile
  __shared__ int64_t tile_at[kRadix];    // a digit's first place in the tile
  __shared__ int tile_count[kRadix];     // the tile's keys of a digit
  __shared__ int64_t adj[kRadix];        // the one pass: offsets[c] + base[c]
  __shared__ int tile_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int w = 0; w < kWarps; ++w) wrun[w][tid] = 0;
  const bool one_pass = digits == nullptr;
  if (one_pass && key_out == nullptr && tid < C)
    adj[tid] = __ldg(offsets + tid) + (base != nullptr ? __ldg(base + tid) : 0);
  if (tid == 0) tile_s = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int tile = tile_s;
  const int64_t first = static_cast<int64_t>(tile) * kTile + warp * (kItems * 32) + lane;
  int key[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t i = first + s * 32;
    key[s] = i < n ? key_of(comp, key_in, i, C) : -1;
  }
  // each key's rank among its warp's earlier keys of its digit
  const unsigned below = (1u << lane) - 1u;
  int rank[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const bool live = key[s] >= 0;
    const int dg = live ? (key[s] >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    const int last = 31 - __clz(peers);
    int before = 0;
    if (live && lane == last) before = atomicAdd(&wrun[warp][dg], __popc(peers));
    rank[s] = __shfl_sync(0xffffffffu, before, last) + __popc(peers & below);
  }
  __syncthreads();
  // thread d, digit d: the earlier warps' keys of it and the tile's count,
  // published at once; the digit's start in the pass's order
  const int d = tid;
  int c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = wrun[w][d];
    wrun[w][d] = c;
    c += x;
  }
  u64* words = state + static_cast<int64_t>(tile) * radix;
  if (d < radix) store_state(words + d, (tile == 0 ? kPrefix : kAggregate) | static_cast<u64>(c));
  tile_count[d] = c;
  const int64_t start = one_pass ? 0 : block_exclusive(d < radix ? __ldg(digits + d) : 0);
  tile_at[d] = start;
  __syncthreads();
  // warp w, digits w, w + kWarps, ...: the tiles before this one
  for (int dw = warp; dw < radix && tile > 0; dw += kWarps) {
    const int64_t prior = look_back(state, tile, radix, dw);
    if (lane == 0) {
      store_state(words + dw, kPrefix | static_cast<u64>(prior + tile_count[dw]));
      tile_at[dw] += prior;
    }
  }
  __syncthreads();
  // every key's stream value (or row) loaded, then every store made
  if (key_out != nullptr) {
    int64_t row[kItems];
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      const int64_t i = first + s * 32;
      row[s] = key[s] < 0 ? 0 : row_in != nullptr ? row_in[i] : i;
    }
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      if (key[s] < 0) continue;
      const int dg = (key[s] >> shift) & (kRadix - 1);
      const int64_t p = tile_at[dg] + wrun[warp][dg] + rank[s];
      key_out[p] = key[s];
      row_out[p] = row[s];
    }
    return;
  }
  int64_t val[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int k = key[s];
    val[s] = 0;
    if (k < 0 || k >= C) continue;
    const int dg = (k >> shift) & (kRadix - 1);
    const int64_t p = tile_at[dg] + wrun[warp][dg] + rank[s];
    const int64_t q = one_pass ? p + adj[k]
                               : p - __ldg(local_start + k) + __ldg(offsets + k) +
                                     (base != nullptr ? __ldg(base + k) : 0);
    if (q >= 0 && q < t) val[s] = __ldg(stream + q);
  }
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    if (key[s] < 0) continue;
    const int64_t i = first + s * 32;
    tag[row_in != nullptr ? row_in[i] : i] = val[s];
  }
}

// counts[c] = the rows of component c (0 <= c < C) among the n of comp: a
// shared-memory histogram a block where C fits kHistShared, else global
// atomics, each warp-aggregated. With digits (passes > 1): digits[p, v] =
// the keys 0..C (C for a row outside [0, C)) whose digit of pass p is v.
// A thread loads its kItems labels before it counts any; the shared
// histograms are sized at launch (hist_smem), so that a small C leaves
// room for more blocks.
constexpr int kHistShared = 8192;
constexpr int kMaxPasses = 4;

inline size_t hist_smem(int C, int passes) {
  return (static_cast<size_t>(C <= kHistShared ? C : 0) + passes * kRadix) * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ comp, int64_t n, int C,
            unsigned long long* __restrict__ counts, int passes,
            unsigned long long* __restrict__ digits) {
  extern __shared__ int hist_s[];
  const bool shared = C <= kHistShared;
  int* hist = hist_s;                               // [C] where shared
  int* dhist = hist_s + (shared ? C : 0);           // [passes, kRadix]
  if (shared)
    for (int c = threadIdx.x; c < C; c += kThreads) hist[c] = 0;
  for (int v = threadIdx.x; v < passes * kRadix; v += kThreads) dhist[v] = 0;
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  int label[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int64_t i = first + it * kThreads;
    label[it] = i < n ? comp[i] : -1;
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int c = label[it];
    const int key = c >= 0 && c < C ? c : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      if (shared) atomicAdd(&hist[key], __popc(peers));
      else atomicAdd(&counts[key], static_cast<unsigned long long>(__popc(peers)));
    }
    if (first + it * kThreads < n)
      for (int p = 0; p < passes; ++p)
        atomicAdd(&dhist[p * kRadix + (((key >= 0 ? key : C) >> (8 * p)) & (kRadix - 1))], 1);
  }
  __syncthreads();
  if (shared)
    for (int c = threadIdx.x; c < C; c += kThreads)
      if (hist[c]) atomicAdd(&counts[c], static_cast<unsigned long long>(hist[c]));
  for (int v = threadIdx.x; v < passes * kRadix; v += kThreads)
    if (dhist[v]) atomicAdd(&digits[v], static_cast<unsigned long long>(dhist[v]));
}

// out[j] = the sum of in[0 .. j - 1], one block. Warp w owns a run of
// entries (a multiple of 32 long) and reads it coalesced, a lane an entry a
// round: first the run's sum, then, after the warps' sums are scanned, the
// run again, each round scanned across the lanes by shuffles and carried to
// the next. Each pass issues kUnroll rounds' loads before it uses the
// first: a lone block has nothing else to hide their L2 latency behind.
constexpr int kUnroll = 8;
constexpr int kScanWarps = kScanThreads / 32;

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int64_t m) {
  __shared__ int64_t warp_base[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per = ((m + kScanWarps - 1) / kScanWarps + 31) & ~int64_t{31};
  const int64_t a = min(m, warp * per), b = min(m, a + per);
  int64_t sum = 0;
  for (int64_t j0 = a + lane; j0 < b; j0 += 32 * kUnroll) {
    int64_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = j0 + 32 * u < b ? in[j0 + 32 * u] : 0;
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
    for (int u = 0; u < kUnroll; ++u) v[u] = j0 + 32 * u < b ? in[j0 + 32 * u] : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int64_t inc = v[u];
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      if (j0 + 32 * u < b) out[j0 + 32 * u] = carry + inc - v[u];
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
}

}  // namespace

extern "C" {

// counts [C] int64 = the rows of each component among comp [n] (labels
// outside [0, C) are not counted); with passes > 1 also digits [passes,
// 256] int64, every pass's digit totals over the keys 0..C (passes 0:
// digits unused). Both are zeroed here.
int pgt_merge_hist(const int* comp, int64_t n, int C, int64_t* counts, int passes,
                   int64_t* digits, void* stream) {
  if (n < 0 || C < 1 || passes < 0 || passes > kMaxPasses || (passes > 0 && !digits))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, static_cast<size_t>(C) * sizeof(int64_t), st);
  if (err == cudaSuccess && passes > 0)
    err = cudaMemsetAsync(digits, 0, static_cast<size_t>(passes) * kRadix * sizeof(int64_t),
                          st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  hist_kernel<<<static_cast<unsigned>(tiles), kThreads, hist_smem(C, passes), st>>>(
      comp, n, C, reinterpret_cast<unsigned long long*>(counts), passes,
      reinterpret_cast<unsigned long long*>(digits));
  return static_cast<int>(cudaGetLastError());
}

// out [m] = the exclusive scan of in [m].
int pgt_merge_scan(const int64_t* in, int64_t* out, int64_t m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, m);
  return static_cast<int>(cudaGetLastError());
}

// One pass of the sort, one launch (state [ceil(n / 4096) * radix + 1]
// int64 is zeroed here): the keys' digit (key >> shift) & 255 (keys: comp,
// C where it is outside [0, C), when key_in is null; else key_in; rows:
// row_in, or i where it is null). digits: the pass's digit totals [256], or
// null in the one pass of C <= 255. key_out non-null: (key, row) at its
// place into key_out / row_out; else the last pass: tag[row] =
// stream_vals[place - local_start[key] + offsets[key] + base[key]]
// (local_start null in the one pass, base null: 0) for a key below C where
// that index lies in the stream, and 0 otherwise.
int pgt_merge_place(const int* comp, const int* key_in, const int64_t* row_in, int64_t n,
                    int C, int shift, int radix, const int64_t* digits, int64_t* state,
                    int* key_out, int64_t* row_out, const int64_t* stream_vals, int64_t t,
                    const int64_t* offsets, const int64_t* base, const int64_t* local_start,
                    int64_t* tag, void* stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const bool last = key_out == nullptr;
  if (n <= 0 || C < 0 || radix < 1 || radix > kRadix || tiles >= (int64_t{1} << 31) ||
      (!last && !row_out) || (last && (!tag || (C > 0 && !offsets))) ||
      (last && digits && C > 0 && !local_start) || (!digits && C >= kRadix))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t words = static_cast<size_t>(tiles) * radix + 1;
  cudaError_t err = cudaMemsetAsync(state, 0, words * sizeof(u64), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* words_p = reinterpret_cast<u64*>(state);
  place_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      comp, key_in, row_in, n, C, shift, radix, digits, words_p,
      reinterpret_cast<unsigned*>(words_p + words - 1), key_out, row_out, stream_vals, t,
      offsets, base, local_start, tag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
