// K5: the gather-rate probe - random 64-byte row gathers, independent
// (row_gather) or as dependent chains (gather_chain).
//
// row_gather replaces examples/gather_pipeline_probe.py:make_pallas_rowdma,
// a Pallas kernel that moved B/G groups of G consecutive rows of a
// [R, 16] int32 table into VMEM by DMA, K copies in flight on K semaphores.
// Output row j*G + g is T[idx[j*G] + g]: a group reads its first index only.
// Here four threads share a 64-byte row, each doing one 16-byte (int4) load,
// so a G-row group is one contiguous G x 64-byte span read fully coalesced.
// The TPU's "K copies in flight" has no counterpart as such: on this card
// the loads in flight are set by how many independent row loads a thread
// issues before it stores any, which is the template parameter DEPTH
// (1, 4 or 16) in place of K. What bounds it: random 64-byte transactions
// into a 20 MB table that sits in the 50 MB L2, i.e. the L2's transaction
// rate and the latency each warp waits for; DEPTH trades threads for loads
// in flight per thread. The sum over rows stays outside, in PyTorch.
//
// gather_chain replaces xla_gather_loop (gather_pipeline_probe.py:56), an
// XLA program: ITERS dependent gathers per lane, each lane's next index a
// hash of the value it just read. One thread per lane, so a lane is a chain
// of load latencies - the regime the MEM kernel (K3) runs in. Only column 0
// of each row is used, so only its 4 bytes are loaded (one 32-byte sector,
// the same latency as the full row). The hash is computed in uint32 because
// idx * 40503 overflows int32 (JAX wraps; signed overflow is undefined in
// CUDA); jnp.remainder is a floor mod, so the index stays non-negative (a
// 32-bit remainder, fixed up when negative: an int64 one would add its own
// long dependent instruction sequence to every step); the per-lane sum
// wraps in int32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 16;          // int32 columns per row (64 bytes)
constexpr int kQuads = kWidth / 4;  // int4 loads per row
constexpr int kThreads = 256;

// Thread t serves quarter q = t % 4 of DEPTH rows, strided by the number of
// row slots in the grid, and issues all DEPTH loads before any store.
template <int DEPTH>
__global__ void row_gather_kernel(const int4* __restrict__ table,
                                  int64_t n_rows, const int* __restrict__ idx,
                                  int64_t n_out, int group,
                                  int4* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int q = static_cast<int>(t % kQuads);
  const int64_t slot = t / kQuads;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x / kQuads;
  int4 v[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int64_t row = slot + d * stride;
    if (row < n_out) {
      const int64_t head = row - row % group;
      int64_t src = static_cast<int64_t>(__ldg(idx + head)) + (row - head);
      src = src < 0 ? 0 : (src >= n_rows ? n_rows - 1 : src);
      v[d] = __ldg(table + src * kQuads + q);
    }
  }
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int64_t row = slot + d * stride;
    if (row < n_out) out[row * kQuads + q] = v[d];
  }
}

__global__ void gather_chain_kernel(const int* __restrict__ table,
                                    int64_t n_rows, const int* __restrict__ idx,
                                    int64_t n, int iters,
                                    int* __restrict__ acc_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int rows32 = static_cast<int>(n_rows);  // < 2^31 (the wrapper checks)
  int64_t j = __ldg(idx + i);
  uint32_t acc = 0;
  for (int it = 0; it < iters; ++it) {
    const int64_t row = j < 0 ? 0 : (j >= n_rows ? n_rows - 1 : j);
    const uint32_t v = static_cast<uint32_t>(__ldg(table + row * kWidth));
    acc += v;
    const uint32_t mixed =
        (v ^ (static_cast<uint32_t>(j) * 40503u)) + static_cast<uint32_t>(it);
    const int r = static_cast<int32_t>(mixed) % rows32;
    j = r < 0 ? r + rows32 : r;
  }
  acc_out[i] = static_cast<int>(acc);
}

template <int DEPTH>
int launch_rows(const int* table, int64_t n_rows, const int* idx,
                int64_t n_out, int group, int* out, void* stream) {
  const int64_t slots = (n_out + DEPTH - 1) / DEPTH;
  const int64_t threads = slots * kQuads;
  if (threads > 0) {
    row_gather_kernel<DEPTH><<<static_cast<unsigned>(
                                   (threads + kThreads - 1) / kThreads),
                               kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const int4*>(table), n_rows, idx, n_out, group,
        reinterpret_cast<int4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[r, :] = table[clamp(idx[r - r % group] + r % group), :] for a
// [n_rows, 16] int32 table; depth is 1, 4 or 16 (anything else:
// cudaErrorInvalidValue, nothing launched)
int pgt_row_gather(const int* table, int64_t n_rows, const int* idx,
                   int64_t n_out, int group, int depth, int* out,
                   void* stream) {
  switch (depth) {
    case 1: return launch_rows<1>(table, n_rows, idx, n_out, group, out, stream);
    case 4: return launch_rows<4>(table, n_rows, idx, n_out, group, out, stream);
    case 16: return launch_rows<16>(table, n_rows, idx, n_out, group, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// acc[i] = sum over `iters` dependent steps of table[j, 0], j hashed from
// the value read (xla_gather_loop)
int pgt_gather_chain(const int* table, int64_t n_rows, const int* idx,
                     int64_t n, int iters, int* acc, void* stream) {
  if (n > 0) {
    gather_chain_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, n_rows, idx, n, iters, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
