// Block-level building blocks of the grid kernels (explain_row.cu,
// run_uniform_sharded.cu): warp reductions, per-block partials gathered
// with shared-memory atomics, a block-wide exclusive scan, and a radix
// select of the k largest of n UNIQUE int64 keys.
//
// The radix select: the keys are offset by their minimum (u = key − min,
// exact in uint64), so only the bits where the keys differ are walked:
// 8-bit digits from the highest differing bit down, each pass a 256-bin
// histogram in shared memory (warp-aggregated atomics: the keys of a
// warp often share a digit) over the keys whose higher digits equal the
// prefix chosen so far, then a scan over the bins from the top to find
// the digit where the count reaches k. The walk stops at the first digit
// whose bin holds exactly the keys still wanted: then "u >= prefix" is
// the selection. Unique keys make the stop certain by the last digit.
// The keys may lie in shared or global memory; every thread of the block
// must call these functions.
#pragma once

#include "lean_eval.cuh"

#define KT_FULL 0xffffffffu
#define KT_I64_MAX 9223372036854775807LL

__device__ __forceinline__ int64_t warp_sum64(int64_t x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(KT_FULL, x, o);
  return x;
}

__device__ __forceinline__ int64_t warp_max64(int64_t x) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t y = __shfl_down_sync(KT_FULL, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__device__ __forceinline__ int64_t warp_min64(int64_t x) {
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t y = __shfl_down_sync(KT_FULL, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// per-block partials: each warp reduces, its lane 0 folds into a shared
// slot (exact for integers in any order); the caller zeroes / seeds the
// slots and puts a barrier before and after
__device__ __forceinline__ void acc_add(int64_t* slot, int64_t x) {
  x = warp_sum64(x);
  if ((threadIdx.x & 31) == 0 && x != 0)
    atomicAdd((unsigned long long*)slot, (unsigned long long)x);
}

__device__ __forceinline__ void acc_max(int64_t* slot, int64_t x) {
  x = warp_max64(x);
  if ((threadIdx.x & 31) == 0) atomicMax((long long*)slot, (long long)x);
}

__device__ __forceinline__ void acc_min(int64_t* slot, int64_t x) {
  x = warp_min64(x);
  if ((threadIdx.x & 31) == 0) atomicMin((long long*)slot, (long long)x);
}

// keys read per thread per round: their loads are issued together
constexpr int SEL_BATCH = 4;

// keys r + q·BLOCK + threadIdx.x, q < SEL_BATCH (0 past n)
template <int BLOCK, class KeyAt>
__device__ __forceinline__ void load_batch(KeyAt key, int n, int r,
                                           int64_t* x) {
#pragma unroll
  for (int q = 0; q < SEL_BATCH; ++q) {
    const int i = r + q * BLOCK + threadIdx.x;
    x[q] = i < n ? key(i) : 0;
  }
}

template <int BLOCK>
struct SelScratch {
  static_assert(BLOCK >= 256 && BLOCK % 32 == 0, "one bin a thread");
  unsigned int hist[256];
  int64_t warp[BLOCK / 32];
  int64_t lo, hi;
  int64_t total;
  unsigned long long prefix;
  int64_t want;
  int done;
  unsigned int count;
};

// exclusive prefix sum of x over the block (thread order); *total gets
// the sum. Starts and ends with a barrier.
template <int BLOCK>
__device__ int64_t block_exscan(int64_t x, SelScratch<BLOCK>& sh,
                                int64_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int64_t incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(KT_FULL, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();
  if (lane == 31) sh.warp[w] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t run = 0;
    for (int k = 0; k < BLOCK / 32; ++k) {
      const int64_t t = sh.warp[k];
      sh.warp[k] = run;
      run += t;
    }
    sh.total = run;
  }
  __syncthreads();
  *total = sh.total;
  return sh.warp[w] + incl - x;
}

// the smallest key T such that exactly k of the n unique keys key(0),
// ..., key(n − 1) are >= T (1 <= k <= n); the keys are read, never written
template <int BLOCK, class KeyAt>
__device__ int64_t block_select_kth(KeyAt key, int n, int k,
                                    SelScratch<BLOCK>& sh) {
  int64_t lo = KT_I64_MAX, hi = KT_I64_MIN;
  for (int r = 0; r < n; r += SEL_BATCH * BLOCK) {
    int64_t x[SEL_BATCH];
    load_batch<BLOCK>(key, n, r, x);
#pragma unroll
    for (int q = 0; q < SEL_BATCH; ++q) {
      if (r + q * BLOCK + (int)threadIdx.x >= n) continue;
      lo = x[q] < lo ? x[q] : lo;
      hi = x[q] > hi ? x[q] : hi;
    }
  }
  __syncthreads();            // the previous call's readers are done
  if (threadIdx.x == 0) {
    sh.lo = KT_I64_MAX;
    sh.hi = KT_I64_MIN;
    sh.prefix = 0;
    sh.want = k;
    sh.done = 0;
  }
  __syncthreads();
  acc_min(&sh.lo, lo);
  acc_max(&sh.hi, hi);
  __syncthreads();
  const int64_t base = sh.lo;
  if (k >= n) return base;
  const unsigned long long range =
      (unsigned long long)sh.hi - (unsigned long long)base;
  const int bits = 64 - __clzll((long long)range);
  int shift = ((bits + 7) / 8) * 8 - 8;
  for (; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += BLOCK) sh.hist[b] = 0;
    __syncthreads();
    const unsigned long long prefix = sh.prefix;
    const unsigned long long hmask =
        shift + 8 >= 64 ? 0ull : (~0ull << (shift + 8));
    // every thread runs the same number of rounds, so the warp votes
    // see whole warps
    for (int r = 0; r < n; r += SEL_BATCH * BLOCK) {
      int64_t x[SEL_BATCH];
      load_batch<BLOCK>(key, n, r, x);
#pragma unroll
      for (int q = 0; q < SEL_BATCH; ++q) {
        unsigned int digit = 256;               // no bin
        if (r + q * BLOCK + (int)threadIdx.x < n) {
          const unsigned long long u =
              (unsigned long long)x[q] - (unsigned long long)base;
          if ((u & hmask) == prefix)
            digit = (unsigned int)(u >> shift) & 255u;
        }
        const unsigned int peers = __match_any_sync(KT_FULL, digit);
        if (digit < 256 && (__ffs(peers) - 1) == (int)(threadIdx.x & 31))
          atomicAdd(&sh.hist[digit], (unsigned int)__popc(peers));
      }
    }
    __syncthreads();
    // bins from the top: thread t holds bin 255 − t
    const int t = threadIdx.x;
    const int64_t h = t < 256 ? (int64_t)sh.hist[255 - t] : 0;
    int64_t tot;
    const int64_t above = block_exscan<BLOCK>(h, sh, &tot);
    const int64_t want = sh.want;
    if (t < 256 && above < want && above + h >= want) {
      sh.prefix = prefix | ((unsigned long long)(255 - t) << shift);
      sh.want = want - above;
      sh.done = h == want - above;
    }
    __syncthreads();
    if (sh.done) break;
    __syncthreads();
  }
  return (int64_t)((unsigned long long)base + sh.prefix);
}

// the keys key(i) >= T into out[0, count) when `out` is given and their
// indices into idx when `idx` is; returns the count. The order is the
// warps' arrival order (the callers read the result as a set): each warp
// takes its slots with one shared atomic. Starts and ends with a barrier.
template <int BLOCK, class KeyAt>
__device__ int block_compact_ge(KeyAt key, int n, int64_t T, int64_t* out,
                                int32_t* idx, SelScratch<BLOCK>& sh) {
  __syncthreads();
  if (threadIdx.x == 0) sh.count = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < n; r += SEL_BATCH * BLOCK) {
    int64_t x[SEL_BATCH];
    load_batch<BLOCK>(key, n, r, x);
#pragma unroll
    for (int q = 0; q < SEL_BATCH; ++q) {
      const int i = r + q * BLOCK + threadIdx.x;
      const bool take = i < n && x[q] >= T;
      const unsigned int vote = __ballot_sync(KT_FULL, take);
      if (vote == 0) continue;                // the whole warp
      const int lead = __ffs(vote) - 1;
      unsigned int base = 0;
      if (lane == lead)
        base = atomicAdd(&sh.count, (unsigned int)__popc(vote));
      base = __shfl_sync(KT_FULL, base, lead);
      if (take) {
        const unsigned int at = base + __popc(vote & ((1u << lane) - 1u));
        if (out) out[at] = x[q];
        if (idx) idx[at] = i;
      }
    }
  }
  __syncthreads();
  return (int)sh.count;
}
