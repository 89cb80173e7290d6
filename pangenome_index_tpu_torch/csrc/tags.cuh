// Tag-array search pieces shared by K4 (tagquery.cu) and K6 (tagbatch.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pgt {

// encoded_start_every_k_run of the reference (tag_arrays.hpp:120)
constexpr int kStartEveryK = 10;
// the "no value" filler of the JAX code: a pos_enc equal to it is never kept
constexpr int64_t kBig = INT64_MAX;

__device__ __forceinline__ int64_t load64(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// number of run heads <= v (searchsorted side="right"); log2(n) dependent
// loads, the top levels shared by every thread and so cache-resident
__device__ __forceinline__ int64_t upper_bound(const int* __restrict__ a,
                                               int64_t n, int v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace pgt
