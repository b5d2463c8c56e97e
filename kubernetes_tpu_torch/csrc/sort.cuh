// Descending bitonic sort of int64 keys in device memory (n a power of
// two). The keys of the uniform and wave runs are unique (the node index
// and the matrix column are folded in), so the order is total and no
// stability is needed. kt_sort_desc (host side): chunks of SORT_CHUNK keys
// sort and merge in shared memory; only the strides of SORT_CHUNK and
// above go through global memory, one launch per stride. block_sort_desc
// (device side): the whole network inside one block, for kernels that
// keep a dependent chain on one SM (run_wave.cu) or sort a block's share
// in shared memory (explain_row.cu, run_uniform_sharded.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SORT_CHUNK 2048
#define SORT_THREADS 1024

__device__ __forceinline__ void kt_cmpx(int64_t* s, int t, int l, bool desc) {
  const int64_t a = s[t], b = s[l];
  if (desc ? (a < b) : (a > b)) {
    s[t] = b;
    s[l] = a;
  }
}

// every chunk fully sorted for stages k = 2 .. min(n, SORT_CHUNK); the
// direction of each subsequence follows its GLOBAL index, so the chunks
// come out as the bitonic network's next inputs
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_chunk_sort(int64_t* keys, int n) {
  __shared__ int64_t s[SORT_CHUNK];
  const int cn = n < SORT_CHUNK ? n : SORT_CHUNK;
  const int base = blockIdx.x * cn;
  for (int t = threadIdx.x; t < cn; t += SORT_THREADS) s[t] = keys[base + t];
  __syncthreads();
  for (int k = 2; k <= cn; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < cn; t += SORT_THREADS) {
        const int l = t ^ j;
        if (l > t) kt_cmpx(s, t, l, ((base + t) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < cn; t += SORT_THREADS) keys[base + t] = s[t];
}

// one global compare-exchange stride j (>= SORT_CHUNK) of stage k
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_global_step(int64_t* keys, int n, int k, int j) {
  const int t = blockIdx.x * SORT_THREADS + threadIdx.x;
  if (t >= n) return;
  const int l = t ^ j;
  if (l > t) kt_cmpx(keys, t, l, (t & k) == 0);
}

// the strides below SORT_CHUNK of stage k, in shared memory
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_chunk_merge(int64_t* keys, int n, int k) {
  __shared__ int64_t s[SORT_CHUNK];
  const int base = blockIdx.x * SORT_CHUNK;
  for (int t = threadIdx.x; t < SORT_CHUNK; t += SORT_THREADS)
    s[t] = keys[base + t];
  __syncthreads();
  for (int j = SORT_CHUNK >> 1; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < SORT_CHUNK; t += SORT_THREADS) {
      const int l = t ^ j;
      if (l > t) kt_cmpx(s, t, l, ((base + t) & k) == 0);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < SORT_CHUNK; t += SORT_THREADS)
    keys[base + t] = s[t];
}

static void kt_sort_desc(int64_t* keys, int n, cudaStream_t stream) {
  if (n < 2) return;
  const int cn = n < SORT_CHUNK ? n : SORT_CHUNK;
  bitonic_chunk_sort<<<n / cn, SORT_THREADS, 0, stream>>>(keys, n);
  for (int k = 2 * SORT_CHUNK; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= SORT_CHUNK; j >>= 1)
      bitonic_global_step<<<(n + SORT_THREADS - 1) / SORT_THREADS,
                            SORT_THREADS, 0, stream>>>(keys, n, k, j);
    bitonic_chunk_merge<<<n / SORT_CHUNK, SORT_THREADS, 0, stream>>>(keys, n,
                                                                      k);
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
