// run_uniform: closed-form assignment of a same-signature run of pods,
// and with the gang verdict run_gang's closed-form tier.
//
// Replaces kubernetes_tpu/ops/program.py run_uniform (:1207; the jit
// _run_uniform_jit :1190 over _uniform_core :1076 and _uniform_matrix
// :1007) with its nominated-pod overlay variant (:1135-1140), and
// kubernetes_tpu/ops/gang.py _run_gang_uniform_jit (:199; entry run_gang
// :221 with uniform=True).
//
// The run's pods take the top entries of a [K, J] matrix of
// post-placement scores (entry (k, j) = the score of candidate node k
// after its (j+1)-th placement), keyed (score desc, node asc, j asc)
// (closed_form.cuh); the candidates are the top K rows of the run's row.
// Pod i < n_actual takes the node of the i-th key.
//
// What only the set decides (as in run_uniform_sharded.cu). An entry's
// key folds in its node and column, not the candidate's rank, and the
// monotonicity flag, the per-node counts, the depth flag and the cache
// refresh are per candidate. So the candidates and the n_actual counted
// entries are SELECTIONS (radix selects of unique keys: any order of the
// same set gives the same bits), and only the counted entries are put in
// order. With K = N every row is a candidate and nothing is selected.
//
// Design: ONE cooperative launch, a grid of G blocks of 256 threads (G =
// min(max(ceil(N / 256), ceil(K·J / 256)), SMs)), with grid barriers
// (cooperative_groups grid.sync, as explain_row.cu) between the phases:
//   0. a thread a row: the row's SigCache parts into the fresh cache (the
//      overlay in its fit only) or the cached ones on a hit, and each
//      block's image counts, valid rows and feasible maxima as partials,
//      which every block folds after the barrier; the global slots are
//      seeded;
//   1. a thread a row: ImageLocality on a miss; when K < N the row keys;
//   2. when K < N: the top K rows, compacted into the candidates through
//      one global counter (a warp takes its slots with one atomic);
//   3. the [K, J] matrix, a thread an entry;
//   4. the monotonicity check, and the top n_actual entries compacted: an
//      atomic counts each node's feasible selected entries, and its old
//      value J − 1 marks a node that took all J (the depth flag);
//   5. the verdict BEFORE any write: exact (monotone, normalization
//      constant), depth, placed, accept = placed >= needed; the gang
//      applies the run only when accept ∧ exact ∧ depth, a plain run
//      always. The output carry is written element by element over the
//      grid: the input's rows plus, where the run applies, each node's
//      placements; the cache is refreshed at each candidate, or, where
//      the run does not apply, the fresh SigCache takes the input's back.
//      Then the order of the selected keys: each tile of at most `tile`
//      keys sorted in one block's shared memory; with one tile its block
//      writes the assignments; with more, after a last barrier, a key's
//      position is its place in its own tile plus, in every other tile,
//      the keys above it (a binary search, over the tiles staged in
//      shared memory where they fit): unique keys, so the positions are
//      a permutation.
// A radix select of n keys (select.cuh's walk, spread over the grid):
// every block histograms its share of each 8-bit digit into that digit's
// global bins, a barrier, and every block reads the bins and takes the
// same digit (the grid walks the same passes).
// A thread's copies issue every load of a round before its stores: a
// store could alias a later load, so a load-store chain would wait on
// each load in turn.
//
// What bounds it on an H100: latency. The bytes (the node rows once, the
// matrix, the carry) are microseconds of HBM time; a row's filters are a
// chain of dependent loads, then come the barriers and the digit passes.
// Keys are int64 (the JAX program narrows them to int32 where the range
// allows; values and order are the same).

#include <cooperative_groups.h>

#include "closed_form.cuh"
#include "select.cuh"
#include "sort.cuh"

namespace cg = cooperative_groups;

// the kernel's arguments, mirrored field for field by ctypes
// (ops/kernels.py UniformArgsC); every scratch pointer is a piece of one
// buffer the wrapper allocates
struct UniformArgs {
  NodeC na;
  TableC tb;
  CarryC cin;             // read only
  CarryC cout;            // fresh tensors, written in full
  CfgC cfg;
  const int64_t* ovl_used;    // [N, R] the overlay; null for none
  const int32_t* ovl_npods;   // [N]
  int32_t sig, tidx, K, J, L, n_actual;
  int32_t gang, needed;   // the gang tier and its remaining quorum
  int32_t tile;           // keys a block orders in shared memory (pow2)
  int32_t rank_smem;      // the sorted tiles staged in shared memory for
                          // the rank search (else searched in place)
  int64_t* part;          // [G, KT_SHARD_LOC] phase 0's partials
  int64_t* slots;         // [NSLOT] global reductions and counters
  uint32_t* hist;         // [2, MAX_PASSES, 256] the grid selects' bins
  int64_t* keys0;         // [N] row keys (K < N)
  int32_t* cand;          // [K] the candidate rows, in no order (K < N)
  int64_t* keys1;         // [K·J] the matrix keys
  uint8_t* fit_kj;        // [K·J]
  int64_t* sfit_kj;
  int64_t* sbal_kj;
  int32_t* counts;        // [N] feasible selected entries a node
  int64_t* sel;           // [n_actual] the selected keys, then tiles
  int32_t* packed;        // [L + 2], with the gang [L + 4]
};

namespace {

constexpr int BLOCK = 256;
constexpr int LOC = KT_SHARD_LOC;
constexpr int MAX_PASSES = 8;       // 8-bit digits of a 64-bit range
// the global slots (ops/kernels.py UNI_SLOTS)
constexpr int S_ROW_LO = 0;         // the row keys' range
constexpr int S_ROW_HI = 1;
constexpr int S_KEY_LO = 2;         // the matrix keys' range
constexpr int S_KEY_HI = 3;
constexpr int S_NOT_MONO = 4;
constexpr int S_DEEP = 5;
constexpr int S_PLACED = 6;
constexpr int S_CAND = 7;           // compaction counters
constexpr int S_SEL = 8;
constexpr int NSLOT = 9;

__device__ __forceinline__ int64_t slot_seed(int s) {
  return s == S_ROW_LO || s == S_KEY_LO ? KT_I64_MAX
       : s == S_ROW_HI || s == S_KEY_HI ? KT_I64_MIN : 0;
}

// what another block wrote before a grid barrier, read past L1
__device__ __forceinline__ int64_t ld_cg(const int64_t* p) {
  return (int64_t)__ldcg((const long long*)p);
}

// the node of a selected key, −1 for an infeasible entry
__device__ __forceinline__ int32_t node_of(int64_t key, int64_t M, int J) {
  return key > -M ? (int32_t)((kt_key_score(key, M) * M - key) / J) : -1;
}

// this lane's slot in a list that a global counter fills, or −1 when
// `take` is false: one atomic a warp. Every lane of the warp calls it.
__device__ __forceinline__ int64_t warp_slot(bool take, int64_t* ctr) {
  const unsigned int vote = __ballot_sync(KT_FULL, take);
  if (vote == 0) return -1;
  const int lane = threadIdx.x & 31, lead = __ffs(vote) - 1;
  unsigned long long base = 0;
  if (lane == lead)
    base = atomicAdd((unsigned long long*)ctr,
                     (unsigned long long)__popc(vote));
  base = __shfl_sync(KT_FULL, base, lead);
  return take ? (int64_t)base + __popc(vote & ((1u << lane) - 1u)) : -1;
}

// the smallest key T such that exactly k of the n unique keys are >= T
// (1 <= k < n), by the whole grid: the keys lie in [bounds[0],
// bounds[1]], which other blocks wrote; `hist` holds MAX_PASSES · 256
// zeroed bins. Every block walks the same passes.
__device__ int64_t grid_select_kth(cg::grid_group& grid,
                                   const int64_t* keys, int n, int k,
                                   const int64_t* bounds, uint32_t* hist,
                                   SelScratch<BLOCK>& sh) {
  const int t = threadIdx.x;
  const int64_t lo = ld_cg(bounds), hi = ld_cg(bounds + 1);
  const unsigned long long range =
      (unsigned long long)hi - (unsigned long long)lo;
  const int bits = 64 - __clzll((long long)range);
  unsigned long long prefix = 0;
  int64_t want = k;
  for (int shift = ((bits + 7) / 8) * 8 - 8; shift >= 0;
       shift -= 8, hist += 256) {
    for (int b = t; b < 256; b += BLOCK) sh.hist[b] = 0;
    __syncthreads();
    const unsigned long long hmask =
        shift + 8 >= 64 ? 0ull : (~0ull << (shift + 8));
    // the block's threads run the same rounds: whole warps vote
    for (int r = blockIdx.x * BLOCK; r < n; r += gridDim.x * BLOCK) {
      const int i = r + t;
      unsigned int digit = 256;               // no bin
      if (i < n) {
        const unsigned long long u =
            (unsigned long long)ld_cg(keys + i) - (unsigned long long)lo;
        if ((u & hmask) == prefix) digit = (unsigned int)(u >> shift) & 255u;
      }
      const unsigned int peers = __match_any_sync(KT_FULL, digit);
      if (digit < 256 && (__ffs(peers) - 1) == (t & 31))
        atomicAdd(&sh.hist[digit], (unsigned int)__popc(peers));
    }
    __syncthreads();
    for (int b = t; b < 256; b += BLOCK)
      if (sh.hist[b]) atomicAdd(&hist[b], sh.hist[b]);
    grid.sync();
    // the grid's bins from the top: thread t holds bin 255 − t
    const int64_t h = t < 256 ? (int64_t)__ldcg(&hist[255 - t]) : 0;
    int64_t tot;
    const int64_t above = block_exscan<BLOCK>(h, sh, &tot);
    if (t < 256 && above < want && above + h >= want) {
      sh.prefix = prefix | ((unsigned long long)(255 - t) << shift);
      sh.want = want - above;
      sh.done = h == want - above;
    }
    __syncthreads();
    prefix = sh.prefix;
    want = sh.want;
    const bool done = sh.done;
    __syncthreads();
    if (done) break;
  }
  return (int64_t)((unsigned long long)lo + prefix);
}

// keys of the sorted (descending) tile s[0, m) above `key`; s lies in
// shared memory, or with `global` in global memory
__device__ __forceinline__ int count_above(const int64_t* s, int m,
                                           int64_t key, bool global) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((global ? ld_cg(s + mid) : s[mid]) > key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the output carry, element by element over the grid: the input's rows
// plus each node's placements (`apply`: counts[n] · the request; else
// nothing), every load of a round before its stores
__device__ __forceinline__ void write_carry(const UniformArgs& a,
                                            const PodRowD& p, bool apply,
                                            int first, int stride) {
  const int N = a.na.N, R = a.na.R, NR = N * R;   // < 2^31 (the wrapper)
  for (int e0 = first; e0 < NR; e0 += 4 * stride) {
    int64_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * stride;
      if (e < NR) {
        const int n = e / R;
        const int64_t cnt = apply ? __ldcg(a.counts + n) : 0;
        v[q] = a.cin.used[e] + cnt * p.req[e - n * R];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * stride;
      if (e < NR) a.cout.used[e] = v[q];
    }
  }
  for (int n = first; n < N; n += stride) {
    const int64_t cnt = apply ? __ldcg(a.counts + n) : 0;
    const int64_t z0 =
        a.cin.nonzero_used[(int64_t)n * 2] + cnt * p.nonzero_req[0];
    const int64_t z1 =
        a.cin.nonzero_used[(int64_t)n * 2 + 1] + cnt * p.nonzero_req[1];
    const int32_t np = a.cin.npods[n] + (int32_t)cnt;
    a.cout.nonzero_used[(int64_t)n * 2] = z0;
    a.cout.nonzero_used[(int64_t)n * 2 + 1] = z1;
    a.cout.npods[n] = np;
  }
}

__global__ void __launch_bounds__(BLOCK) uniform_kernel(UniformArgs a) {
  extern __shared__ int64_t tile_sh[];
  __shared__ SelScratch<BLOCK> ss;
  __shared__ int64_t acc[LOC];
  __shared__ int64_t glob[LOC];     // the folded cluster-wide values
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, G = gridDim.x;
  const int stride = G * BLOCK, first = blockIdx.x * BLOCK + t;
  const int N = a.na.N, K = a.K, J = a.J, L = a.L, KJ = K * J;
  const int n_sel = a.n_actual;
  const int64_t M = (int64_t)N * J;
  const bool all_rows = K == N;
  const PodRowD p = pod_row(a.tb, a.tidx);
  const bool use_fast = a.sig != 0 && a.sig == *a.cin.cache.sig;
  const OvlD ovl{a.ovl_used, a.ovl_npods};
  const CacheC& out = a.cout.cache;

  // 0. the rows' parts and partials; the global slots seeded
  if (t < LOC) acc[t] = 0;
  for (int i = first; i < 2 * MAX_PASSES * 256; i += stride) a.hist[i] = 0;
  if (first < NSLOT) a.slots[first] = slot_seed(first);
  for (int n = first; n < N; n += stride) a.counts[n] = 0;
  if (first == 0) *out.sig = a.sig;
  __syncthreads();
  {
    int64_t cnt[KT_MAX_IC];
    for (int c = 0; c < a.tb.IC; ++c) cnt[c] = 0;
    int64_t nvalid = 0, tm = 0, nm = 0;
    for (int n = first; n < N; n += stride)
      kt_closed_row(a.cfg, a.na, a.tb, a.cin, a.cout, p, n, use_fast, ovl,
                    cnt, nvalid, tm, nm);
    for (int c = 0; c < a.tb.IC; ++c) acc_add(&acc[c], cnt[c]);
    acc_add(&acc[KT_MAX_IC], nvalid);
    acc_max(&acc[KT_MAX_IC + 1], tm);
    acc_max(&acc[KT_MAX_IC + 2], nm);
  }
  __syncthreads();
  if (t < LOC) {
    a.part[(int64_t)blockIdx.x * LOC + t] = acc[t];
    glob[t] = 0;
  }
  grid.sync();
  for (int e = t; e < G * LOC; e += BLOCK) {
    const int c = e % LOC;
    const int64_t x = a.part[e];
    if (c <= KT_MAX_IC)
      atomicAdd((unsigned long long*)&glob[c], (unsigned long long)x);
    else
      atomicMax((long long*)&glob[c], (long long)x);
  }
  __syncthreads();

  // 1. ImageLocality on a miss; the row keys and their range
  if (!use_fast || !all_rows) {
    int64_t lo = KT_I64_MAX, hi = KT_I64_MIN;
    for (int n = first; n < N; n += stride) {
      if (!use_fast) shard_s_img(a.na, a.tb, p, n, glob, out);
      if (all_rows) continue;
      const int64_t k0 = kt_row_key(a.cfg, out, n, N, glob);
      a.keys0[n] = k0;
      lo = k0 < lo ? k0 : lo;
      hi = k0 > hi ? k0 : hi;
    }
    if (!all_rows) {
      acc_min(&a.slots[S_ROW_LO], lo);
      acc_max(&a.slots[S_ROW_HI], hi);
    }
    grid.sync();
  }

  // 2. the top K rows (K < N), in no order
  if (!all_rows) {
    const int64_t T = grid_select_kth(grid, a.keys0, N, K,
                                      &a.slots[S_ROW_LO], a.hist, ss);
    for (int r = blockIdx.x * BLOCK; r < N; r += stride) {
      const int n = r + t;
      const bool take = n < N && ld_cg(a.keys0 + n) >= T;
      const int64_t at = warp_slot(take, &a.slots[S_CAND]);
      if (take) a.cand[at] = n;
    }
    grid.sync();
  }

  // 3. the matrix, a thread an entry, and its keys' range
  {
    int64_t lo = KT_I64_MAX, hi = KT_I64_MIN;
    for (int e = first; e < KJ; e += stride) {
      const int k = e / J, j = e - k * J;
      const int node = all_rows ? k : __ldcg(a.cand + k);
      const int64_t key = kt_matrix_entry(
          a.cfg, a.na, a.cin, out, p, glob, ovl, node, node, j, J, M, e,
          a.fit_kj, a.sfit_kj, a.sbal_kj);
      a.keys1[e] = key;
      lo = key < lo ? key : lo;
      hi = key > hi ? key : hi;
    }
    acc_min(&a.slots[S_KEY_LO], lo);
    acc_max(&a.slots[S_KEY_HI], hi);
  }
  grid.sync();

  // 4. the monotonicity check; the top n_actual entries counted
  {
    bool mono = true;
    for (int e = first; e < KJ; e += stride)
      if (e % J != 0 && kt_key_score(ld_cg(a.keys1 + e), M)
                            > kt_key_score(ld_cg(a.keys1 + e - 1), M))
        mono = false;
    if (!mono) a.slots[S_NOT_MONO] = 1;
    const int64_t T = n_sel > 0 && n_sel < KJ
        ? grid_select_kth(grid, a.keys1, KJ, n_sel, &a.slots[S_KEY_LO],
                          a.hist + MAX_PASSES * 256, ss)
        : KT_I64_MIN;
    int64_t placed = 0;
    bool deep = false;
    for (int r = blockIdx.x * BLOCK; r < KJ; r += stride) {
      const int e = r + t;
      const int64_t key = e < KJ ? ld_cg(a.keys1 + e) : 0;
      const bool take = n_sel > 0 && e < KJ && key >= T;
      const int64_t at = warp_slot(take, &a.slots[S_SEL]);
      if (take) {
        a.sel[at] = key;
        if (key > -M) {
          const int k = e / J;
          const int node = all_rows ? k : __ldcg(a.cand + k);
          ++placed;
          deep = atomicAdd(&a.counts[node], 1) == J - 1 || deep;
        }
      }
    }
    acc_add(&a.slots[S_PLACED], placed);
    if (deep) a.slots[S_DEEP] = 1;
  }
  grid.sync();

  // 5. the verdict before any write, then the carry and the order
  const int64_t placed = ld_cg(&a.slots[S_PLACED]);
  const bool exact = ld_cg(&a.slots[S_NOT_MONO]) == 0
                     && glob[KT_MAX_IC + 1] == 0 && glob[KT_MAX_IC + 2] == 0;
  const bool depth = ld_cg(&a.slots[S_DEEP]) == 0;
  const bool accept = placed >= a.needed;
  const bool apply = !a.gang || (accept && exact && depth);
  write_carry(a, p, apply, first, stride);
  if (apply) {
    for (int k = first; k < K; k += stride) {
      const int node = all_rows ? k : __ldcg(a.cand + k);
      kt_cache_refresh(out, node, __ldcg(a.counts + node), J,
                       (int64_t)k * J, a.fit_kj, a.sfit_kj, a.sbal_kj);
    }
  } else {
    for (int n = first; n < N; n += stride) kt_cache_copy(a.cin.cache, out, n);
    if (first == 0) *out.sig = *a.cin.cache.sig;
  }
  if (first == 0) {
    if (a.gang) {
      a.packed[L] = accept;
      a.packed[L + 1] = (int32_t)placed;
      a.packed[L + 2] = exact;
      a.packed[L + 3] = depth;
    } else {
      a.packed[L] = exact;
      a.packed[L + 1] = depth;
    }
  }
  for (int i = n_sel + first; i < L; i += stride) a.packed[i] = -1;
  const int tiles = (n_sel + a.tile - 1) / a.tile;
  for (int b = blockIdx.x; b < tiles; b += G) {
    const int base = b * a.tile;
    const int m = min(a.tile, n_sel - base);
    int P = 1;
    while (P < m) P <<= 1;
    __syncthreads();          // the previous tile's readers are done
    for (int i = t; i < P; i += BLOCK)
      tile_sh[i] = i < m ? ld_cg(a.sel + base + i) : KT_I64_MIN;
    block_sort_desc<BLOCK>(tile_sh, P);
    for (int i = t; i < m; i += BLOCK) {
      if (tiles == 1) a.packed[i] = node_of(tile_sh[i], M, J);
      else a.sel[base + i] = tile_sh[i];
    }
  }
  if (tiles > 1) {
    grid.sync();
    // the blocks that rank keys stage every sorted tile first
    const bool staged = a.rank_smem != 0;
    if (staged && blockIdx.x * BLOCK < n_sel) {
      for (int i = t; i < n_sel; i += BLOCK) tile_sh[i] = ld_cg(a.sel + i);
      __syncthreads();
    }
    const int64_t* srt = staged ? tile_sh : a.sel;
    for (int i = first; i < n_sel; i += stride) {
      const int own = i / a.tile;
      const int64_t key = staged ? srt[i] : ld_cg(srt + i);
      int rank = i - own * a.tile;
      for (int b = 0; b < tiles; ++b)
        if (b != own)
          rank += count_above(srt + (int64_t)b * a.tile,
                              min(a.tile, n_sel - b * a.tile), key, !staged);
      a.packed[rank] = node_of(key, M, J);
    }
  }
}

}  // namespace

// one run; `grid` is the wrapper's G (its partials' scratch is sized by
// it). The cooperative launch refuses a grid the card cannot keep
// resident (cudaErrorCooperativeLaunchTooLarge).
extern "C" int ktpu_run_uniform(const UniformArgs* args, int grid,
                                void* stream) {
  // the dynamic shared memory granted so far, per device
  static int granted[64] = {0};
  const UniformArgs a = *args;
  const int keys_sh = a.rank_smem && a.n_actual > a.tile ? a.n_actual
                                                         : a.tile;
  const int smem = keys_sh * (int)sizeof(int64_t);
  cudaError_t e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    e = cudaFuncSetAttribute(uniform_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = smem;
  }
  void* kargs[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)uniform_kernel, dim3(grid),
                                  dim3(BLOCK), kargs, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
