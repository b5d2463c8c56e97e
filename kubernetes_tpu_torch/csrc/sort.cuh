// Descending bitonic sort of int64 keys (n a power of two) inside one
// block. The keys of the uniform and wave runs are unique (the node index
// and the matrix column are folded in), so the order is total and no
// stability is needed. For kernels that sort a block's share in shared
// memory (explain_row.cu, run_uniform.cu, run_uniform_sharded.cu, the
// leader CTA of run_wave.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void kt_cmpx(int64_t* s, int t, int l, bool desc) {
  const int64_t a = s[t], b = s[l];
  if (desc ? (a < b) : (a > b)) {
    s[t] = b;
    s[l] = a;
  }
}

// the full network over keys[0, n) by the calling block alone (every
// thread of the block must call it); ends with a barrier
template <int BLOCK>
__device__ void block_sort_desc(int64_t* keys, int n) {
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n; t += BLOCK) {
        const int l = t ^ j;
        if (l > t) kt_cmpx(keys, t, l, (t & k) == 0);
      }
      __syncthreads();
    }
  }
}
